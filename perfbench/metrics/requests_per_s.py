"""Requests completed in the window over the whole window (a request is a
camera frame, its label on the host)."""
from perfbench import window


def read(rec):
    return window.frames(rec) / window.seconds(rec)
