"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, builds nothing when imported, and never falls back to the CPU on
its own."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

SLICE = [
    "repro_torch", "repro_torch.device",
    "repro_torch.core", "repro_torch.core.metrics",
    "repro_torch.core.hardware", "repro_torch.core.calibrate",
    "repro_torch.core.atoms", "repro_torch.core.schedule",
    "repro_torch.core.emulator", "repro_torch.core.predictor",
    "repro_torch.core.store", "repro_torch.core.watchers",
    "repro_torch.obs", "repro_torch.obs.clock",
    "repro_torch.obs.recorder", "repro_torch.obs.metrics",
    "repro_torch.obs.trace",
    "repro_torch.service", "repro_torch.service.slo",
    "repro_torch.service.arrivals", "repro_torch.service.standing",
    "repro_torch.service.load", "repro_torch.service.http",
    "repro_torch.service.__main__",
    "repro_torch.fleet", "repro_torch.fleet.bundle",
    "repro_torch.fleet.chaos", "repro_torch.fleet.config",
    "repro_torch.fleet.dag", "repro_torch.fleet.executor",
    "repro_torch.fleet.worker", "repro_torch.fleet.agent",
    "repro_torch.fleet.transport", "repro_torch.fleet.transport.framing",
    "repro_torch.fleet.transport.remote",
    "repro_torch.kernels", "repro_torch.kernels.build",
    "repro_torch.kernels.compute_atom",
    "repro_torch.kernels.compute_atom.kernel",
    "repro_torch.kernels.compute_atom.ops",
    "repro_torch.kernels.compute_atom.ref",
    "repro_torch.kernels.memory_atom",
    "repro_torch.kernels.memory_atom.kernel",
    "repro_torch.kernels.memory_atom.ops",
    "repro_torch.kernels.memory_atom.ref",
    "repro_torch.kernels.collective",
    "repro_torch.kernels.collective.kernel",
    "repro_torch.kernels.collective.ops",
    "repro_torch.kernels.collective.ref",
    "repro_torch.kernels.segment", "repro_torch.kernels.segment.kernel",
    "repro_torch.kernels.segment.ops", "repro_torch.kernels.segment.ref",
    "repro_torch.launch", "repro_torch.launch.mesh",
    "repro_torch.scenarios", "repro_torch.scenarios.base",
    "repro_torch.scenarios.serving", "repro_torch.scenarios.algebra",
    "repro_torch.scenarios.training", "repro_torch.scenarios.fanout",
    "repro_torch.scenarios.retry", "repro_torch.scenarios.mixed",
    "repro_torch.scenarios.dag", "repro_torch.scenarios.driver",
    "repro_torch.scenarios.__main__",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.run", "repro_torch.configs.gemma2_2b",
    "repro_torch.configs.hymba_1_5b",
    "repro_torch.configs.llama4_scout_17b_a16e",
    "repro_torch.configs.mamba2_780m",
    "repro_torch.configs.moonshot_v1_16b_a3b",
    "repro_torch.configs.qwen2_1_5b", "repro_torch.configs.qwen2_72b",
    "repro_torch.configs.qwen2_7b", "repro_torch.configs.qwen2_vl_2b",
    "repro_torch.configs.seamless_m4t_medium",
    "repro_torch.models", "repro_torch.models.params",
    "repro_torch.models.layers", "repro_torch.models.transformer",
    "repro_torch.models.model_zoo", "repro_torch.models.moe",
    "repro_torch.models.ssm", "repro_torch.models.hybrid",
    "repro_torch.models.encdec", "repro_torch.models.frontends",
    "repro_torch.parallel", "repro_torch.parallel.sharding",
    "repro_torch.serve", "repro_torch.serve.step",
    "repro_torch.serve.engine",
    "repro_torch.train", "repro_torch.train.loss", "repro_torch.train.step",
    "repro_torch.train.loop",
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.compression",
    "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
    "repro_torch.runtime", "repro_torch.runtime.supervisor",
]

_CHILD = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
from repro_torch.kernels import build
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"bad": bad, "built": build._lib is not None}))
"""


def test_import_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _CHILD, *SLICE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "built": False}


def _port_files():
    for d, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


_FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\b(?!_)"
                        r"|from repro\.|from repro import)", re.M)


def test_port_sources_name_no_jax_or_repro():
    files = list(_port_files())
    assert len(files) > 20
    # the scan reaches every subpackage, this slice's included
    for sub in ("fleet", "obs", "service", "scenarios", "transport",
                "launch", "collective", "train", "optim", "data",
                "checkpoint", "runtime", "parallel"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    for path in files:
        with open(path) as f:
            hits = _FORBIDDEN.findall(f.read())
        assert not hits, f"{path}: {hits}"


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.run import SERVE_RUN
    from repro_torch.core import (Emulator, HostCalibration, calibrate)
    from repro_torch.core.atoms import ComputeAtom, MemoryAtom
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import from_numpy
    from repro_torch.serve.engine import Engine
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.params import train_state_from_numpy
    from repro_torch.train.loop import make_job
    from repro_torch.models import frontends
    from repro_torch.models.ssm import init_mamba_cache
    cal = HostCalibration(1e9, 1e9, 1e8, 1e8)
    model = build_model(reduced_config(get_config("qwen2-7b")), SERVE_RUN)
    families = [build_model(reduced_config(get_config(a)), SERVE_RUN)
                for a in ("mamba2-780m", "hymba-1.5b",
                          "seamless-m4t-medium")]
    ckpt_dir = str(tmp_path / "ck")
    ckpt = CheckpointManager(ckpt_dir)
    ckpt.save(1, {"w": torch.zeros(2)})
    for make in (lambda: model.init(torch.Generator()),
                 lambda: model.init_cache(1, 8),
                 lambda: from_numpy({}),
                 lambda: Engine(model, {}),
                 lambda: Emulator(),
                 lambda: Emulator(calib=cal),
                 lambda: Emulator(calib=cal, backend="cuda"),
                 lambda: ComputeAtom(cal),
                 lambda: MemoryAtom(cal),
                 lambda: make_mesh((2,), ("model",)),
                 lambda: SyntheticLM(DataConfig(8, 4, 1)),
                 lambda: make_job(model.cfg, SERVE_RUN, ckpt_dir=ckpt_dir),
                 lambda: train_state_from_numpy(
                     {"params": {}, "opt": {"mu": {}, "nu": {}, "step": 0}}),
                 lambda: ckpt.restore(),
                 lambda: calibrate(),
                 lambda: frontends.mrope_positions(1, 4),
                 lambda: frontends.audio_frame_embeddings(
                     torch.Generator(), 1, 4, 8),
                 lambda: frontends.vision_patch_embeddings(
                     torch.Generator(), 1, 4, 8),
                 lambda: init_mamba_cache(families[0].cfg, 1),
                 *(lambda m=m: m.init_cache(1, 8) for m in families)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_kernel_build_reports_missing_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the toolkit's default nvcc exists here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
