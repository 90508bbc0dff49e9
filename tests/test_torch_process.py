"""The port's process stage contains host errors and never device errors.

``process_pile_ups`` contains a failing pile-up as the JAX package does:
a ``consensusBatchFailed`` retry one pile-up at a time, then a
``pileUpSkipped`` log line.  A device error (a kernel that refused its
arguments, failed to launch or faulted, or the card out of memory) must
stop the run instead, also outside strict mode.  The pile-ups come from
a small seeded scenario mapped by the JAX package on the CPU.
"""

import io
import json

import numpy as np
import pytest
import torch

from dentist_tpu_torch.device import set_device
from dentist_tpu_torch.errors import KernelError
from dentist_tpu_torch.models import process as P
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def scenario():
    from dentist_tpu.io.fasta import FastaRecord
    from dentist_tpu.models.pileups import ChainCtx, CollectConfig, collect_pile_ups
    from dentist_tpu.models.sequences import SeqStore, split_scaffolds
    from dentist_tpu.ops.mapper import MapperConfig, map_reads
    from dentist_tpu.sim.genome import random_genome
    from dentist_tpu.sim.partial import build_partial_assembly
    from dentist_tpu.sim.reads import simulate_reads
    from dentist_tpu.utils.regions import Region

    truth = [random_genome(16_000, seed=90)]
    gaps = Region.from_triples([(0, 8000, 8100)])
    contigs, structure = split_scaffolds(
        [FastaRecord("scaf0", build_partial_assembly(truth, gaps)[0])])
    read_list, _ = simulate_reads(truth, coverage=12, mean_length=5000,
                                  sd_length=1000, error=0.13, seed=91)
    reads = SeqStore(np.concatenate(read_list),
                     np.array([len(r) for r in read_list]))
    repeats = Region.from_triples([])
    las, chains = map_reads(contigs.codes, contigs.offsets, contigs.lengths,
                            read_list, config=MapperConfig())
    ctx = ChainCtx(las, chains, contigs.lengths, reads.lengths)
    pile_ups = collect_pile_ups(ctx, structure.gaps, repeats, CollectConfig())
    assert pile_ups and len(pile_ups[0]) >= 3
    return pile_ups, ctx, contigs, reads, repeats


@pytest.fixture
def events(monkeypatch):
    """Outside strict mode, on the CPU; yields the event names that the
    port's log and the JAX package's log wrote."""
    import dentist_tpu.utils.log as log
    import dentist_tpu_torch.utils.log as port_log

    set_device("cpu")
    monkeypatch.delenv("DENTIST_TPU_STRICT", raising=False)
    stream = io.StringIO()
    monkeypatch.setattr(log, "_stream", stream)
    monkeypatch.setattr(port_log, "_stream", stream)
    yield lambda: [json.loads(line).get("event")
                   for line in stream.getvalue().splitlines()]


def test_refused_kernel_launch_stops_the_run(scenario, events):
    """K2's wrapper refuses a band width above 1024 (the card kernel
    keeps the band in registers); the refusal reaches the caller instead
    of skipping the pile-up."""
    with pytest.raises(KernelError, match="unsupported shape"):
        P.process_pile_ups(*scenario, P.ProcessConfig(band_width=1025))
    assert "pileUpSkipped" not in events()
    assert "consensusBatchFailed" not in events()


@pytest.mark.parametrize("exc", [
    KernelError("launch failed"),
    torch.cuda.OutOfMemoryError("out of memory"),
    torch.AcceleratorError("CUDA error: an illegal memory access"),
], ids=["kernel", "out_of_memory", "cuda_fault"])
def test_device_errors_are_not_contained(scenario, events, monkeypatch, exc):
    def failing(*args, **kwargs):
        raise exc

    monkeypatch.setattr(P, "consensus_batch", failing)
    with pytest.raises(type(exc)):
        P.process_pile_ups(*scenario)
    assert "pileUpSkipped" not in events()


@pytest.mark.parametrize("exc", [RuntimeError("host"), ValueError("host")],
                         ids=["runtime_error", "value_error"])
def test_host_errors_are_contained_as_in_jax(scenario, events, monkeypatch, exc):
    """A host error in consensus skips the pile-up with a logged reason,
    as the JAX package's process stage does."""
    import dentist_tpu.models.process as jax_process

    def failing(*args, **kwargs):
        raise exc

    monkeypatch.setattr(P, "consensus_batch", failing)
    monkeypatch.setattr(jax_process, "consensus_batch", failing)
    assert P.process_pile_ups(*scenario) == []
    port_events = events()
    assert "consensusBatchFailed" in port_events
    assert "pileUpSkipped" in port_events
    assert jax_process.process_pile_ups(*scenario) == []
    assert events().count("pileUpSkipped") == 2 * port_events.count("pileUpSkipped")
