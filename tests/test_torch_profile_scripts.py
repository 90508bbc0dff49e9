"""What the port's profiling scripts rest on, held on the CPU.

- ``scenarios.phase_c_scenario`` builds ``bench.py``'s phase C as the
  JAX package's sim functions do in ``bench.py``'s order and seeds, and
  ``scenarios.inexact_gaps`` finds the gaps a window scan finds.
- ``scripts/profile_e2e_process_torch.py``'s consensus instrumentation
  patches only names that ``dentist_tpu_torch.ops.consensus`` calls, sees
  the rounds and the polish dispatch, and changes no result: the
  instrumented ``consensus_batch`` equals the plain one and JAX's.
- Its cache refuses a pickle of another format or of JAX package classes.
- ``utils/stacks.StackSampler`` charges time to pool workers and to the
  stages their stacks mark, which ``cProfile`` cannot on Python 3.12.
- ``scripts/bench_consensus_kernel_torch.py`` runs on the CPU at small
  shapes.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from dentist_tpu_torch.device import set_device
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_c_scenario_equals_bench_datagen():
    from dentist_tpu.sim.genome import insert_repeats, random_genome
    from dentist_tpu.sim.partial import build_partial_assembly, random_gaps
    from dentist_tpu.sim.reads import simulate_reads
    from dentist_tpu_torch.scenarios import phase_c_scenario

    # bench.py:187-201 at 1 Mb and 5 gaps
    e2e_size = 1_000_000
    g = random_genome(e2e_size, seed=321)
    g = insert_repeats(g, n_copies=4 * (e2e_size // 1_000_000),
                       repeat_length=3000, seed=322)
    e_gaps = random_gaps([g], n_gaps=5, min_size=100, max_size=1000,
                         margin=25_000, seed=323)
    e_asm = build_partial_assembly([g], e_gaps)
    e_reads, _ = simulate_reads([g], coverage=20.0, mean_length=25000,
                                sd_length=12500, error=0.13, seed=324)

    sc = phase_c_scenario(mb=1, n_gaps=5)
    assert len(sc.truths) == 1
    np.testing.assert_array_equal(sc.truths[0], g)
    np.testing.assert_array_equal(sc.gaps.iv, e_gaps.iv)
    assert [r.header for r in sc.assembly] == [f"scaf{i}" for i in range(len(e_asm))]
    for rec, want in zip(sc.assembly, e_asm, strict=True):
        np.testing.assert_array_equal(rec.codes, want)
    assert len(sc.reads) == len(e_reads)
    for got, want in zip(sc.reads, e_reads):
        np.testing.assert_array_equal(got, want)


def _contains(haystack: np.ndarray, needle: np.ndarray) -> bool:
    """Whether ``needle`` is a run of ``haystack``: every window compared."""
    if len(needle) > len(haystack):
        return False
    win = np.lib.stride_tricks.sliding_window_view(haystack, len(needle))
    return any((win[s : s + (1 << 16)] == needle).all(axis=1).any()
               for s in range(0, len(win), 1 << 16))


def test_inexact_gaps_equal_a_window_scan():
    from dentist_tpu_torch.scenarios import (closed_exactly, inexact_gaps,
                                             phase_c_scenario)

    sc = phase_c_scenario(mb=0.2, n_gaps=3)
    truth = sc.truths[0]
    broken = truth.copy()
    sid, b, e = (int(x) for x in sc.gaps.iv[1])
    broken[(b + e) // 2] = (broken[(b + e) // 2] + 1) % 4  # one gap wrong
    for outs in ([truth], [broken], [broken[: b - 600], broken[b - 600:]],
                 [truth[:1000]]):
        want = [(int(s), int(b0), int(e0)) for s, b0, e0 in sc.gaps.iv
                if not any(_contains(o, truth[b0 - 500 : e0 + 500]) for o in outs)]
        assert inexact_gaps(sc, outs) == want
        assert closed_exactly(sc, outs) == len(sc.gaps.iv) - len(want)
    assert inexact_gaps(sc, [broken]) == [(sid, b, e)]


def test_consensus_instrumentation_counts_and_changes_nothing(monkeypatch):
    from dentist_tpu.ops.consensus import consensus_batch as jax_cons
    from dentist_tpu.sim.genome import random_genome
    from dentist_tpu.sim.reads import _mutate
    from dentist_tpu_torch.ops import consensus as C
    from dentist_tpu_torch.ops import nw_dist, nw_round

    set_device("cpu")
    monkeypatch.setenv("DENTIST_TPU_FORCE_SINGLE", "1")
    mod = _script("profile_e2e_process_torch")
    names = [*mod.DISPATCHES, *mod.TOTALS]
    for name in names:  # each is a name the consensus module calls
        assert callable(getattr(C, name)), name
    assert C.nw_round_packed is nw_round.nw_round_packed
    assert C.nw_dist_pairs_packed is nw_dist.nw_dist_pairs_packed
    saved = {name: getattr(C, name) for name in names}

    # tests/_multihost_worker.py's inputs
    rng = np.random.default_rng(91)
    truth = random_genome(700, seed=90)
    sets = [[_mutate(truth, rng, 0.13) for _ in range(8)] for _ in range(2)]
    plain = C.consensus_batch(sets)
    with mod.instrument() as stats:
        assert C.nw_round_packed is not saved["nw_round_packed"]
        counted = C.consensus_batch(sets)
    assert {name: getattr(C, name) for name in names} == saved
    assert stats["_run_round"][0] >= 1, stats
    assert stats["K3p enqueue"][0] >= 1, stats  # the polish dispatch
    assert stats["_polish_batch"][0] >= 1, stats
    ref = jax_cons(sets)
    for k, (a, b, c) in enumerate(zip(plain, counted, ref, strict=True)):
        for field in ("sequence", "coverage", "read_spans", "read_diffs",
                      "win_diffs"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                          err_msg=f"{k} {field}")
            np.testing.assert_array_equal(getattr(a, field), getattr(c, field),
                                          err_msg=f"{k} {field}")


def test_cache_refuses_other_formats_and_jax_classes(tmp_path):
    from dentist_tpu.utils.regions import Region as JaxRegion
    from dentist_tpu_torch.utils.regions import Region

    mod = _script("profile_e2e_process_torch")
    iv = np.array([[0, 1, 5]], dtype=np.int64)

    def dump(name, blob):
        path = tmp_path / name
        path.write_bytes(pickle.dumps(blob))
        return str(path)

    good = dump("port.pkl", {"format": mod.FORMAT, "mb": 1.0, "n_gaps": 5,
                             "inputs": {"repeat_mask": Region(iv)}})
    np.testing.assert_array_equal(
        mod.load_cache(good, 1.0, 5)["repeat_mask"].iv, Region(iv).iv)
    with pytest.raises(ValueError, match="cached for"):
        mod.load_cache(good, 28.0, 147)
    other = dump("other.pkl", {"format": "something else", "inputs": {}})
    with pytest.raises(ValueError, match="not a cache"):
        mod.load_cache(other, 1.0, 5)
    jax = dump("jax.pkl", {"format": mod.FORMAT, "mb": 1.0, "n_gaps": 5,
                           "inputs": {"repeat_mask": JaxRegion(iv)}})
    with pytest.raises(pickle.UnpicklingError, match="dentist_tpu.utils.regions"):
        mod.load_cache(jax, 1.0, 5)


def _spin(seconds: float) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        sum(range(200))


def only_on_a_worker():
    _spin(0.3)


def only_on_main():
    _spin(0.3)


def test_sampler_charges_pool_workers():
    from dentist_tpu_torch.utils.stacks import StackSampler

    with StackSampler(0.001) as sampler:
        with ThreadPoolExecutor(max_workers=2) as ex:
            fut = ex.submit(only_on_a_worker)
            only_on_main()
            fut.result()
    rows = sampler.report(50)["other"]
    cum = {(r["thread"], r["function"].rsplit("(", 1)[1][:-1]): r["seconds"]
           for r in rows["cumulative"]}
    assert cum.get(("pool:only_on_a_worker", "only_on_a_worker"), 0) > 0.1, rows
    assert cum.get(("main", "only_on_main"), 0) > 0.1, rows
    assert ("main", "only_on_a_worker") not in cum
    assert ("pool:only_on_a_worker", "only_on_main") not in cum
    assert rows["threads"]["pool:only_on_a_worker"] > 0.1
    # the frames around the sampled window are charged nothing
    assert not [k for k in cum if "test_sampler_charges_pool_workers" in k[1]]


def test_sampler_stage_marked_on_a_worker():
    from dentist_tpu_torch.utils.stacks import StackSampler

    started = threading.Event()

    def marker_stage():  # runs on a worker only: marks the stage "worker"
        started.set()
        _spin(0.3)

    here = "tests/" + os.path.basename(__file__)
    stages = (("worker", (f"{here}:marker_stage",)),)
    with StackSampler(0.001, stages) as sampler:
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(marker_stage)
            started.wait(5)
            _spin(0.2)
            fut.result()
        _spin(0.2)
    report = sampler.report(10)
    assert report["worker"]["wall_s"] > 0.1, report.keys()
    assert report["worker"]["threads"]["pool:test_sampler_stage_marked_on_a_worker."
                                       "<locals>.marker_stage"] > 0.1
    assert report["other"]["wall_s"] > 0.1
    assert "pool:" not in "".join(report["other"]["threads"])


def test_bench_script_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "bench_consensus_kernel_torch.py"),
         "--device", "cpu", "--shapes", "64,64,4", "128,96,2", "--reps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert [(r["T"], r["RL"], r["N"], r["NWIN"]) for r in out["shapes"]] == [
        (64, 64, 4, 1), (128, 96, 2, 2)]
    for r in out["shapes"]:
        assert "refused" not in r, r
        assert r["timer"] == "host clock" and r["full_ms"] > 0 and r["scan_ms"] > 0
