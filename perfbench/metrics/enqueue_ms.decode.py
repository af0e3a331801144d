"""enqueue_ms.decode (ms, program span) -- layer: model step
(serve/engine.serve_decode_step -> models/) -- moves output_tokens_per_s.

The mean ``decode`` span a tick of the measured window: the host's time
to enqueue one decode step of every slot (attention, then the channel,
a layer at a time).  Beside ``device_tick_ms.decode``: near or above
it, the tick is host-bound in launching.  None without the program's
spans."""
from perfbench.lib import spans


def read(rec):
    if rec["kind"] != "serve" or "spans" not in rec:
        return None
    ticks = spans.top_level(rec, "tick")
    if not ticks:
        return None
    return 1e3 * spans.seconds(spans.children(rec, ticks, "decode")) \
        / len(ticks)
