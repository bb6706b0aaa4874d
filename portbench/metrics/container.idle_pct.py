"""container.idle_pct: the share of the traced window in which the card
idled while the innermost open program span was one of the container's
(``archon.container.*``: split, stage_in, dispatch, collect, fallback,
frames).  Program span (``portbench/spans.py``)."""

from portbench import spans

spans.install()


def read(w):
    return spans.idle_pct(w, "container")
