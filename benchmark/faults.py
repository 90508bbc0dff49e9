"""Faults planted under a run, which the check has to reject, and the
control.

Each takes the ``setattr`` to plant it with (a test passes its
``monkeypatch.setattr``, which undoes it afterwards) and wraps the
program's own function as it was before any fault, so planting one
twice in a process plants it once.

- ``polish_off``, the control: the program states no precision, so the
  control breaks a guarantee it gives instead, that every closed gap
  carries the polished consensus of its spanning reads.
  ``consensus_batch`` has that path of its own (``polish=False``: the
  realign rounds alone, without the polishing rounds that rescore every
  candidate edit); skipping it is the step that would tempt a later
  change, since it cuts the process stage.
- ``lanes_left_out``: half of the batch left out in the mapping layer:
  of every K1 and K1p launch's lanes that extend, the second half
  return no extension (a launch's lanes are padded up to a bucket, so
  the second half of all its lanes is mostly padding).
- ``diffs_raised``: an answer altered where it is produced: every K1
  and K1p lane that extends reports ``DIFFS_RAISED`` more differences
  (the alignment stays consistent: its last trace interval takes them).
"""

from __future__ import annotations

import functools

#: differences ``diffs_raised`` adds to each extension
DIFFS_RAISED = 8

_ORIG: dict[tuple[str, str], object] = {}


def _orig(mod, name: str):
    return _ORIG.setdefault((mod.__name__, name), getattr(mod, name))


def polish_off(set_attr=setattr) -> None:
    """Make the process stage call ``consensus_batch`` with
    ``polish=False``."""
    from dentist_tpu_torch.models import process
    from dentist_tpu_torch.ops import consensus

    _orig(process, "consensus_batch")
    set_attr(process, "consensus_batch",
             functools.partial(consensus.consensus_batch, polish=False))


def _wrap_extensions(set_attr, alter) -> None:
    from dentist_tpu_torch.ops import banded

    for name in ("extend", "extend_packed"):
        fn = _orig(banded, name)

        def launch(*args, _fn=fn, **kwargs):
            out = _fn(*args, **kwargs)
            alter(out)
            return out
        set_attr(banded, name, launch)


def lanes_left_out(set_attr=setattr) -> None:
    """Zero the second half of the lanes with a score above 0 in every
    K1/K1p result block (a score of 0: no extension)."""
    def alter(out):
        live = (out[3] > 0).nonzero().flatten()
        out[:, live[len(live) // 2:]] = 0
    _wrap_extensions(set_attr, alter)


def diffs_raised(set_attr=setattr) -> None:
    """Add ``DIFFS_RAISED`` to the differences (row 2) of every K1/K1p
    lane whose score (row 3) is above 0."""
    def alter(out):
        out[2] += DIFFS_RAISED * (out[3] > 0).to(out.dtype)
    _wrap_extensions(set_attr, alter)


FAULTS = {"polish_off": polish_off, "lanes_left_out": lanes_left_out,
          "diffs_raised": diffs_raised}
