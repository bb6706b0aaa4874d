"""pack.idle_pct: the share of the traced window in which the card idled
while the innermost open program span was the entropy pack's
(``archon.pack.*``: ``blocks``, the pool's pack of one batch of L).
Program span (``portbench/spans.py``).  A program that opens no such span
reads nothing."""

from portbench import spans

spans.install()


def read(w):
    p = spans.program(w)
    if p is None or "pack" not in p.idle_s:
        return None
    return spans.idle_pct(w, "pack")
