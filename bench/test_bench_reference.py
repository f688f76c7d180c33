"""The plain reference on the CPU: it agrees with the port, imports
neither torch nor the program, computes the control in float32, and its
parts (the activation cache, the Eq. 3 slice, the NoC hop counts) do
what the model says."""
import subprocess
import sys
import types

import numpy as np
import pytest

from bench import harness
from bench.reference import model, rows, simulate
from bench.reference.core.arch import Interconnect
from bench.reference.core.calibrate.asap7 import DEFAULT_CALIB
from bench.reference.core.ir import OpClass, OpNode, OpType
from bench.traffic.generator import GenomeStream

WORKLOADS = ["resnet50_int8", "kan", "snn_vgg9", "hyena_1_3b"]
MIX = {"generator": "sweep", "genomes_per_call": 30, "pool_calls": 1,
       "families": ["homo", "hetero_bl", "hetero_bls"]}


@pytest.mark.parametrize("how", ["exact", "scan"])
def test_reference_matches_the_port(how):
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.engine import EvalEngine
    genomes = GenomeStream(MIX, 2 ** 31 + 11).next_call()
    engine = EvalEngine(WORKLOADS, device="cpu", config=EngineConfig(
        backend=how, nonfinite="skip"))
    prog = engine.evaluate(genomes)
    ref = rows.score(genomes, WORKLOADS, how)
    c = harness.compare(prog, ref, {"max_rel_err": 0, "mask_mismatch": 0})
    assert c["mask_mismatch"]["value"] == 0
    assert c["max_rel_err"]["value"] < 1e-12
    assert np.array_equal(prog["latency"], ref["latency"])


def test_reference_imports_neither_torch_nor_the_program():
    code = ("import sys; sys.path[0:0] = [sys.argv[1]]\n"
            "from bench.reference import rows\n"
            "rows.score([[0] * 43], ['kan'], 'scan')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'torch', 'repro', 'repro_torch', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("num, kind", [(model.F64, float),
                                       (model.F32, np.float32)])
def test_model_computes_in_its_float_type(num, kind):
    chip = rows.decode(np.zeros(43, np.int64))
    tile = model.make_tile(chip.instances()[0], DEFAULT_CALIB, num)
    op = model.make_op(OpNode("mm", OpType.MATMUL, m=64, k=96, n=32)
                       .finalize(), num)
    m = model.Model(DEFAULT_CALIB, num)
    sec, energy, dram_b = m.execute(tile, op, num.f(64.0), op.b_w, 0.0)
    assert sec > 0 and energy > 0 and dram_b > 0
    assert all(type(v) is kind for v in (sec, energy, dram_b))


def test_activation_cache_evicts_oldest_by_bytes_and_slots():
    cache = simulate.Cache([types.SimpleNamespace(cache_cap=100.0)])
    cache.insert(0, 1, 150.0)                 # over the capacity: spills
    assert cache.where == {}
    cache.insert(0, 1, 60.0)
    cache.insert(0, 2, 30.0)
    cache.insert(0, 3, 30.0)                  # 120 > 100: op 1 goes
    assert cache.where == {2: 0, 3: 0}
    for op in range(4, 4 + model.ACT_CACHE_SLOTS):
        cache.insert(0, op, 1.0)
    assert len(cache.fifo[0]) == model.ACT_CACHE_SLOTS
    assert 2 not in cache.where and 3 not in cache.where


@pytest.mark.parametrize("axis, dims", [(0, (10, 8, 2)), (1, (3, 8, 7)),
                                        (2, (10, 2, 7))])
def test_split_op_floors_the_cut_axis(axis, dims):
    op = model.make_op(OpNode("mm", OpType.MATMUL, m=10, k=8, n=7)
                       .finalize(), model.F64)
    sub = model.split_op(op, axis, 3.0, model.F64)
    assert (sub.m, sub.k, sub.n) == dims
    assert sub.macs == dims[0] * dims[1] * dims[2]
    assert sub.cls == OpClass.MAC


@pytest.mark.parametrize("ic, n, hops", [
    (Interconnect.BUS, 16, 1), (Interconnect.RING, 16, 4),
    (Interconnect.RING, 3, 1), (Interconnect.NOC, 16, 2),
    (Interconnect.MESH, 10, 4), (Interconnect.MESH, 1, 1)])
def test_noc_hops(ic, n, hops):
    assert simulate.noc_hops(ic, n) == hops
