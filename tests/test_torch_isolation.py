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
                "apex_tpu_torch/models/resnet.py"):
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
