"""megablock.stage_pct: the share of the card's busy time spent on work
launched under ``archon.megablock.stage`` (the bitonic merge-split stages:
ppermute, cat, the stage's sort, the select), by launch as
``portbench/spans.py`` attributes it.  Program span."""

from portbench import spans

spans.install()


def read(w):
    return spans.device_pct(w, "archon.megablock.stage")
