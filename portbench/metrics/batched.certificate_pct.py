"""batched.certificate_pct: the share of the card's busy time spent on work
launched under ``archon.batched.certificate`` (``verify_bwt_batched``, the
device LF certificate), by launch as ``portbench/spans.py`` attributes it.
Program span."""

from portbench import spans

spans.install()


def read(w):
    return spans.device_pct(w, "archon.batched.certificate")
