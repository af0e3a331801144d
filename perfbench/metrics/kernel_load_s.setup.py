"""kernel_load_s.setup (s, program span) -- layer: kernels
(kernels/isla_moments.library: nvcc where a source is not built, then
the library's load) -- moves setup_s.

The ``kernels.load`` spans that ended before the measured window opened,
summed (``nvcc`` builds included; the record's ``kernel_builds`` says how
many ran).  None without the program's spans."""
from perfbench.lib import spans


def read(rec):
    if "spans" not in rec:
        return None
    return spans.seconds([s for s in rec["spans"]
                          if s["name"] == "kernels.load"
                          and s["end_ns"] is not None
                          and s["end_ns"] <= rec["t0"] * 1e9])
