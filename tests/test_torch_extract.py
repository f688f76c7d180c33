"""PyTorch port, ``core/workloads/extract.py`` (A1b): ``extract_model``
on each of the ten LM configs equals the JAX package's graph op for op
-- names, types, GEMM dims, element counts, precisions, byte counts,
predecessors and every other node field, with ``==`` -- and the
extracted graph prepares for the DSE engine as the reference's does."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.dse.batch_eval import prepare_workload as R_prepare  # noqa: E402
from repro.core.workloads.extract import extract_model as R_extract  # noqa: E402
from repro.models.registry import get_config as R_config  # noqa: E402
from repro_torch.core.dse.batch_eval import prepare_workload as P_prepare  # noqa: E402
from repro_torch.core.workloads.extract import extract_model  # noqa: E402
from repro_torch.models.registry import ARCH_IDS, get_config  # noqa: E402


def _plain(value):
    """An enum by its value, anything else as it is."""
    return getattr(value, "value", value)


def _node(nd):
    return {f.name: _plain(getattr(nd, f.name))
            for f in dataclasses.fields(nd)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_extract_model_equals_the_reference(arch):
    got = extract_model(get_config(arch))
    want = R_extract(R_config(arch))
    assert (got.name, got.family, _plain(got.model_precision)) == \
        (want.name, want.family, _plain(want.model_precision))
    assert len(got.nodes) == len(want.nodes)
    for a, b in zip(got.nodes, want.nodes):
        assert _node(a) == _node(b), a.name
    assert got.total_macs == want.total_macs
    assert got.total_bytes == want.total_bytes


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_extracted_graph_prepares_as_the_reference(arch):
    """The reduced configs at a short sequence, through the engine's
    preparation pass (precision, fusion, op rows): the same arrays."""
    got = P_prepare(extract_model(get_config(arch).reduced(), seq_len=64))
    want = R_prepare(R_extract(R_config(arch).reduced(), seq_len=64))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
