"""admit_share.decode (%, program span) -- layer: serving scheduler
(serve/engine.py BatchScheduler._admit) -- moves output_tokens_per_s.

The ``admit`` spans (a request's prefill, from the queue pop to its slot
being set) over the ``tick`` spans, summed over the ticks of the measured
window: how long the prefills stall every slot.  None without the
program's spans."""
from perfbench.lib import spans


def read(rec):
    if rec["kind"] != "serve" or "spans" not in rec:
        return None
    ticks = spans.top_level(rec, "tick")
    took = spans.seconds([rec["spans"][i] for i in ticks])
    if took <= 0:
        return None
    return 100.0 * spans.seconds(spans.children(rec, ticks, "admit")) / took
