"""PyTorch port, isolation: importing every module of ``repro_torch``
loads neither ``jax`` (nor ``ml_dtypes``, which JAX's bf16 arrays carry)
nor any module of the reference package."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(info.name)
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "ml_dtypes" or m.startswith("ml_dtypes.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
    for mod in ("repro_torch.core.simulator.costs",
                "repro_torch.core.dse.engine", "repro_torch.kernels.ops",
                "repro_torch.kernels.dse_eval",
                "repro_torch.core.dse.prefilter",
                "repro_torch.kernels._build",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.ssm_scan", "repro_torch.numerics",
                "repro_torch.models.config", "repro_torch.models.registry",
                "repro_torch.models.layers", "repro_torch.models.model",
                "repro_torch.models.convert", "repro_torch.launch.tuning",
                "repro_torch.serve.step", "repro_torch.serve.engine",
                "repro_torch.configs.jamba_v0_1_52b",
                "repro_torch.kernels.horner", "repro_torch.optim.adamw",
                "repro_torch.optim.schedule", "repro_torch.optim.compression",
                "repro_torch.data.pipeline", "repro_torch.train.step",
                "repro_torch.train.loop", "repro_torch.train.fault",
                "repro_torch.train.straggler", "repro_torch.checkpoint.ckpt",
                "repro_torch.launch.train",
                "repro_torch.core.simulator.orchestrator",
                "repro_torch.core.simulator.tile",
                "repro_torch.core.simulator.modules",
                "repro_torch.core.simulator.outputs",
                "repro_torch.core.compiler.mapper",
                "repro_torch.core.compiler.schedule",
                "repro_torch.core.compiler.pipeline",
                "repro_torch.core.calibrate.nvdla",
                "repro_torch.core.dse.store", "repro_torch.core.dse.faults",
                "repro_torch.core.dse.device_memo",
                "repro_torch.core.dse.ga_device",
                "repro_torch.core.dse.checkpoint",
                "repro_torch.core.dse.pipeline",
                "repro_torch.serve.dse_service", "repro_torch.serve.cluster",
                "repro_torch.launch.hillclimb",
                "repro_torch.core.workloads.extract"):
        assert mod in out["modules"], mod
