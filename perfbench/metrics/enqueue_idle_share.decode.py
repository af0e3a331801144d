"""enqueue_idle_share.decode (%, program span) -- layer: device -- moves
output_tokens_per_s.

The share of the traced ticks' window (as ``idle_share.decode`` takes
it) in which the card was idle while the host's innermost open program
span was ``decode`` or lay under it (``idle_by_span``, from the
program's spans on the card's clock): the idle that launching the
decode step leaves.  None without the program's spans."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not t or "idle_by_span" not in t \
            or t["window_s"] <= 0:
        return None
    idle = sum(s for path, s in t["idle_by_span"].items()
               if "decode" in path.split("/"))
    return 100.0 * idle / t["window_s"]
