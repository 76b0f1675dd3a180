"""The port stands alone: no module of ``apex_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax``, ``flax`` or ``apex_tpu``; importing the
serve and training packages builds nothing; and the default device is CUDA,
with no silent fall-back to the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "apex_tpu")


def _port_sources():
    files = sorted((ROOT / "apex_tpu_torch").rglob("*.py"))
    assert files
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_serve_loads_no_jax_and_builds_nothing():
    code = (
        "import sys, json\n"
        "import apex_tpu_torch.serve, apex_tpu_torch.amp\n"
        "import apex_tpu_torch.optimizers, apex_tpu_torch.utils\n"
        "import apex_tpu_torch.ops.lm_head_ce, apex_tpu_torch.ops.fp8_matmul\n"
        "import apex_tpu_torch.amp.fp8, apex_tpu_torch.serve.spec\n"
        "import apex_tpu_torch.ops.fused_ce, apex_tpu_torch.ops.xentropy\n"
        "import apex_tpu_torch.contrib.xentropy, apex_tpu_torch.models\n"
        "import apex_tpu_torch.optimizers.fused_sgd\n"
        "import apex_tpu_torch.zero, apex_tpu_torch.zero.fused_update\n"
        "import apex_tpu_torch.contrib.optimizers, apex_tpu_torch.utils.flat\n"
        "import apex_tpu_torch.contrib.optimizers.zero_state\n"
        "import apex_tpu_torch.parallel, apex_tpu_torch.contrib.bottleneck\n"
        "import apex_tpu_torch.scripts.bottleneck_proto\n"
        "import apex_tpu_torch.scripts.vpu_probe, apex_tpu_torch.ops._pad\n"
        "from apex_tpu_torch.ops import _build\n"
        "mods = set(sys.modules)\n"
        "print(json.dumps({\n"
        "  'jax': sorted(m for m in mods if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'apex_tpu')),\n"
        "  'triton': 'triton' in mods,\n"
        "  'loaded': sorted(_build._LIBS)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "triton": False, "loaded": []}


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from apex_tpu_torch import serve
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.serve import cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=16, max_seq_len=16, hidden_size=8,
                    num_layers=1, num_heads=2, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT.init_params(cfg)
    params = GPT.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.ServeEngine(cfg, params, num_pages=4, max_seq_len=16,
                          max_prompt_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache.init_cache(cache.CacheConfig(num_layers=1, kv_heads=2,
                                           head_dim=4, num_pages=4,
                                           page_size=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.naive_generate(cfg, params, [([1, 2], 2)], max_seq_len=8)
    from apex_tpu_torch import amp
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amp.LossScaler("dynamic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amp.init_state()


def test_new_modules_are_checked_for_imports():
    checked = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for mod in ("apex_tpu_torch/amp/fp8.py", "apex_tpu_torch/ops/fp8_matmul.py",
                "apex_tpu_torch/serve/spec.py", "apex_tpu_torch/ops/fused_ce.py",
                "apex_tpu_torch/ops/xentropy.py",
                "apex_tpu_torch/contrib/xentropy/__init__.py",
                "apex_tpu_torch/optimizers/fused_sgd.py",
                "apex_tpu_torch/models/resnet.py",
                "apex_tpu_torch/utils/flat.py",
                "apex_tpu_torch/zero/__init__.py",
                "apex_tpu_torch/zero/rules.py",
                "apex_tpu_torch/zero/comm.py",
                "apex_tpu_torch/zero/update.py",
                "apex_tpu_torch/zero/fused_update.py",
                "apex_tpu_torch/zero/core.py",
                "apex_tpu_torch/zero/optimizer.py",
                "apex_tpu_torch/zero/elastic.py",
                "apex_tpu_torch/zero/step.py",
                "apex_tpu_torch/contrib/optimizers/__init__.py",
                "apex_tpu_torch/contrib/optimizers/distributed_fused_adam.py",
                "apex_tpu_torch/contrib/optimizers/distributed_fused_lamb.py",
                "apex_tpu_torch/contrib/optimizers/zero_state.py",
                "apex_tpu_torch/ops/_pad.py",
                "apex_tpu_torch/parallel/__init__.py",
                "apex_tpu_torch/parallel/sync_batchnorm.py",
                "apex_tpu_torch/contrib/bottleneck/__init__.py",
                "apex_tpu_torch/contrib/bottleneck/bottleneck.py",
                "apex_tpu_torch/scripts/__init__.py",
                "apex_tpu_torch/scripts/bottleneck_proto.py",
                "apex_tpu_torch/scripts/vpu_probe.py"):
        assert mod in checked


def test_fp8_serving_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from apex_tpu_torch import serve
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.serve import cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=16, max_seq_len=16, hidden_size=8,
                    num_layers=2, num_heads=2, dtype=torch.float32)
    params = GPT.init_params(cfg, device="cpu")
    for kw in (dict(fp8_kv=True, fp8_weights=True),
               dict(fp8_weights=True, spec_k=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.ServeEngine(cfg, params, num_pages=4, max_seq_len=16,
                              max_prompt_len=8, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache.init_cache(cache.CacheConfig(num_layers=1, kv_heads=2,
                                           head_dim=4, num_pages=4,
                                           page_size=8, fp8=True))


def test_zero_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The ZeRO path's entry points follow the port's device rule: the
    loss scaler that amp.initialize attaches lives on the model's device,
    and a CUDA tensor handed to the fused update launches the kernel or
    raises — never the plain version."""
    from apex_tpu_torch import amp, zero
    from apex_tpu_torch.models.gpt import GPT, GPTConfig
    from apex_tpu_torch.zero import fused_update as fu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=16, max_seq_len=16, hidden_size=8,
                    num_layers=1, num_heads=2, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT.init_params(cfg)
    model = GPT.init_params(cfg, device="cpu")
    zm, opt = amp.initialize(model, zero.ZeroOptimizer(lr=1e-3),
                             opt_level="O2", verbosity=0, zero=True)
    assert opt._scaler.state.loss_scale.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zero.make_train_step(lambda m: 0.0, zero.ZeroShardedModel(None),
                             zero.ZeroOptimizer(lr=1e-3),
                             scaler=amp.LossScaler("dynamic"))
    z = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        fu.fused_shard_update(z, z, z, z, torch.zeros((), device="meta"),
                              kind="adam", lr=1e-3, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=0.0, adam_w_mode=True,
                              bias_correction=False)


def test_bottleneck_probe_and_syncbn_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """The sixth slice's entry points follow the port's device rule: the
    modules and the scripts' inputs are built on CUDA unless the caller
    asks for the CPU, and a wrapper handed a tensor on another device
    raises — it never falls back to the plain version."""
    from apex_tpu_torch.contrib.bottleneck import SpatialBottleneck
    from apex_tpu_torch.parallel import SyncBatchNorm
    from apex_tpu_torch.scripts import bottleneck_proto as bp
    from apex_tpu_torch.scripts import vpu_probe as vp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: SyncBatchNorm(8),
                  lambda: SpatialBottleneck(16, 4),
                  lambda: bp.make_params(),
                  lambda: bp.make_input(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert SyncBatchNorm(8, device="cpu").weight.device.type == "cpu"
    assert SpatialBottleneck(16, 4, device="cpu").conv1.device.type == "cpu"
    p = bp.make_params(device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        bp.fused_block(torch.zeros(1, 56, 56, 256, device="meta"), p)
    with pytest.raises(ValueError, match="not supported"):
        vp.vpu_probe_kernel(torch.zeros(1, 512, 512, device="meta"), "mul")
