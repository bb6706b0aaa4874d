"""batched.idle_pct: the share of the traced window in which the card idled
while the innermost open program span was one of the batched program's
(``archon.batched.*``: bootstrap, round, micro_tail, emit, certificate).
Program span (``portbench/spans.py``)."""

from portbench import spans

spans.install()


def read(w):
    return spans.idle_pct(w, "batched")
