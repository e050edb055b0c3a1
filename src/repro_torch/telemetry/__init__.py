"""repro_torch.telemetry — the observability plane of both engines (the
port of ``repro.telemetry``).

One contract, two producers (DESIGN.md §8):

* the **fleet** run carries an optional telemetry cube
  (``simulate(..., telemetry=TelemetryConfig(nb, horizon))``) and returns
  a :class:`TelemetryFrame` — per-bucket / per-node event-kind counters,
  queue depth, busy time and event-buffer occupancy high-water marks, all
  fixed-shape, one cube per sweep cell under ``simulate_fn``, and nothing
  allocated or computed when off (on CUDA the ``event_scan`` kernel's
  instantiation without the carry);
* the **host** event heap records the same dynamics through its Hooks
  via :class:`TraceRecorder`, which also exports Chrome-trace-event JSON
  viewable in Perfetto.

Both reduce to :class:`TelemetrySummary`; :func:`compare_summaries`
asserts they agree bucket for bucket (counters / occupancy exactly,
derived integrals within ``DERIVED_ATOL``) — enforced on the paper
scenarios by ``python -m repro_torch.fleetsim.validate --telemetry``.

    from repro_torch import telemetry as tel

    rec = tel.TraceRecorder(network=link)
    orch = Orchestrator(topo, FastPreferentialQueue, hooks=rec.hooks, ...)
    result = orch.run(requests)
    rec.write("trace.json", requests)                 # -> ui.perfetto.dev
    host = rec.summary(requests, topo, 32, result.end_time)

    m = fleetsim.simulate(reqs, ta, params,
                          telemetry=tel.TelemetryConfig(32, result.end_time))
    dev = tel.TelemetrySummary.from_frame(m.telemetry)
    assert tel.compare_summaries(host, dev).ok
"""
from repro_torch.telemetry.summary import (DERIVED_ATOL, TelemetryAgreement,
                                           TelemetrySummary,
                                           compare_summaries)
from repro_torch.telemetry.timeline import (KIND_ARRIVAL, KIND_DISCARD,
                                            KIND_FORWARD, KIND_NAMES,
                                            KIND_REARRIVAL, KIND_SERVE,
                                            N_KINDS, TelemetryConfig,
                                            TelemetryFrame, bucket_of,
                                            bucket_of_np, bucket_width,
                                            interval_histogram,
                                            interval_histogram_np,
                                            telemetry_init)
from repro_torch.telemetry.trace import TraceRecorder, validate_chrome_trace

__all__ = [
    "TelemetryConfig", "TelemetryFrame", "TelemetrySummary",
    "TelemetryAgreement", "TraceRecorder",
    "compare_summaries", "validate_chrome_trace",
    "bucket_width", "bucket_of", "bucket_of_np",
    "interval_histogram", "interval_histogram_np", "telemetry_init",
    "KIND_ARRIVAL", "KIND_REARRIVAL", "KIND_FORWARD", "KIND_DISCARD",
    "KIND_SERVE", "KIND_NAMES", "N_KINDS", "DERIVED_ATOL",
]
