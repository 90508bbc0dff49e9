"""The port's aligner against the JAX package's: which dispatch route a
flush takes.

``DENTIST_TPU_NO_RESIDENT`` turns the device-resident dispatch off in
both packages, so every extension flush ships host-built windows (K1p)
instead of gathering them from the device store (K1).  The records are
the same either way.
"""

import numpy as np
import pytest

from dentist_tpu.ops import aligner as JA
from dentist_tpu.ops import seeding as JS
from dentist_tpu.sim.genome import random_genome
from dentist_tpu.sim.reads import _mutate
from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.ops import aligner as PA
from dentist_tpu_torch.ops import banded as PB
from dentist_tpu_torch.ops import seeding as PS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_FIELDS = ("a_id", "b_id", "complement", "a_begin", "a_end", "b_begin",
           "b_end", "diffs", "trace_offsets", "trace_diffs", "trace_b_adv")


def _store():
    g = random_genome(4000, seed=11)
    lengths = np.array([len(g)], np.int64)
    return g, np.zeros(1, np.int64), lengths


@pytest.mark.parametrize("switch", [None, "1"])
def test_no_resident_switch_as_jax(monkeypatch, switch):
    """With the switch set, both packages' ``Aligner`` turn the resident
    dispatch off where a query store would enable it; without it, both
    turn it on.  The port's flushes then take host windows (K1p's
    ``extend_batch_packed``) or the resident store alone, and give the
    same records."""
    if switch:
        monkeypatch.setenv("DENTIST_TPU_NO_RESIDENT", switch)
    else:
        monkeypatch.delenv("DENTIST_TPU_NO_RESIDENT", raising=False)
    codes, offs, lens = _store()
    store = (codes, offs)
    jax_al = JA.Aligner(JS.KmerIndex(codes, offs, lens, k=14), codes,
                        JA.AlignerConfig(), query_store=store)
    port_al = PA.Aligner(PS.KmerIndex(codes, offs, lens, k=14), codes,
                         PA.AlignerConfig(), query_store=store)
    assert jax_al._use_resident is port_al._use_resident is (switch is None)
    jax_al._dispatch_pool.shutdown()
    port_al._dispatch_pool.shutdown()

    set_device("cpu")
    routes = []
    resident = PA.Aligner._dispatch_resident
    packed = PB.extend_batch_packed

    def dispatch_resident(self, *args, **kwargs):
        routes.append("resident")
        return resident(self, *args, **kwargs)

    def extend_batch_packed(*args, **kwargs):
        routes.append("host")
        return packed(*args, **kwargs)

    monkeypatch.setattr(PA.Aligner, "_dispatch_resident", dispatch_resident)
    monkeypatch.setattr(PB, "extend_batch_packed", extend_batch_packed)
    q = _mutate(codes[1000:3000], np.random.default_rng(12), 0.13)
    cfg = PA.AlignerConfig(band_width=64, min_length=300, batch_size=16)
    las = PA.align_store_pair(codes, offs, lens, [q], config=cfg)
    assert len(las) == 1
    assert routes and set(routes) == {"resident" if switch is None else "host"}
    if switch:  # the records of the resident route, switch unset
        monkeypatch.delenv("DENTIST_TPU_NO_RESIDENT")
        want = PA.align_store_pair(codes, offs, lens, [q], config=cfg)
        assert routes[-1] == "resident"
        for f in _FIELDS:
            np.testing.assert_array_equal(getattr(las, f), getattr(want, f),
                                          err_msg=f)
