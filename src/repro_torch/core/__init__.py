"""Requests, the paper's scenarios and the torch admission ledger."""
