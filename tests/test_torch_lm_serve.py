"""The port's ``ServeEngine`` and the launcher's ``--arch`` half, on the CPU.

``ServeEngine.generate`` (prefill once, then greedy decode into buffers
allocated at ``max_seq``) against the reference's ``ServeEngine`` on the
same (converted) parameters and prompts, on granite-3-8b, rwkv6-1.6b and
qwen3-moe-30b-a3b at SMOKE (the reference's serve-test architectures) and
on zamba2-1.2b with a prompt longer than its attention window (the
window crop): tokens must agree at least 80 % of the time, the
reference's own bound (a bf16 argmax may flip).  For all ten architectures
the port's engine also matches a manual loop of the port's ``api.decode``
(whisper and the vision model take their stub inputs through
``batch_extras``).  Then ``python -m repro_torch.launch.serve --arch
granite-3-8b --smoke --device cpu`` runs end to end, and without
``--device`` it raises where there is no GPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.configs import get_smoke
from repro.models import api as R
from repro.serve import ServeEngine as RefEngine
from repro_torch import configs as TCFG
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import api as T
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
AGREE = 0.8


def _extras(cfg, b):
    rng = np.random.default_rng(1)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (b, cfg.img_seq, cfg.d_model)).astype(np.float32)}
    return None


def _prompts(cfg, b, plen):
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (b, plen)).astype(np.int32)


@pytest.mark.parametrize("arch,plen", [("granite-3-8b", 12),
                                       ("rwkv6-1.6b", 12),
                                       ("qwen3-moe-30b-a3b", 12),
                                       ("zamba2-1.2b", 80)])
def test_engine_matches_reference_engine(arch, plen):
    b, gen = 2, 5
    rcfg = get_smoke(arch)
    rparams = R.init(rcfg, jax.random.PRNGKey(0))
    prompts = _prompts(rcfg, b, plen)
    want = RefEngine(rcfg, rparams, batch_size=b,
                     max_seq=rcfg.max_seq).generate(prompts, n_steps=gen)
    cfg = TCFG.get_smoke(arch)
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    eng = ServeEngine(cfg, params, batch_size=b, max_seq=cfg.max_seq,
                      device="cpu")
    got = eng.generate(prompts, n_steps=gen)
    assert got.shape == (b, gen) and got.dtype == np.int32
    assert (got >= 0).all() and (got < cfg.vocab).all()
    assert (got == want).mean() >= AGREE, (got, want)
    assert len(eng.timings["step_ms"]) == gen - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_manual_decode(arch):
    """The engine against the port's own decode loop: every prompt token
    decoded in turn into a fresh cache, then greedy continuation."""
    cfg = TCFG.get_smoke(arch)
    b, plen, gen = 2, 12, 5
    params = T.init(cfg, 0, "cpu")
    prompts = _prompts(cfg, b, plen)
    extras = _extras(cfg, b)
    got = ServeEngine(cfg, params, batch_size=b, max_seq=cfg.max_seq,
                      device="cpu").generate(prompts, gen,
                                             batch_extras=extras)
    with torch.inference_mode():
        cache = T.init_cache(cfg, b, cfg.max_seq, "cpu")
        if extras is not None:
            # the cross caches come from the prefill side
            _, pre = T.prefill(cfg, params, {
                "tokens": torch.from_numpy(prompts).long(),
                **{k: torch.from_numpy(v) for k, v in extras.items()}})
            cache["cross_k"] = pre["cross_k"].to(cache["cross_k"].dtype)
            cache["cross_v"] = pre["cross_v"].to(cache["cross_v"].dtype)
        toks = torch.from_numpy(prompts).long()
        for i in range(plen):
            logits, cache = T.decode(cfg, params, toks[:, i:i + 1], cache, i)
        manual = []
        for i in range(gen):
            tok = torch.argmax(logits[:, -1], dim=-1).reshape(b, 1)
            manual.append(tok)
            if i < gen - 1:
                logits, cache = T.decode(cfg, params, tok, cache, plen + i)
    manual = torch.cat(manual, dim=1).numpy()
    assert (got == manual).mean() >= AGREE, (got, manual)


def _launch(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_launcher_serves_granite_smoke_on_cpu():
    out = _launch("--arch", "granite-3-8b", "--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "rule admit" in out.stdout
    assert "generated: (4, 16)" in out.stdout
    assert "decode per step p50" in out.stdout


def test_launcher_main_returns_what_it_served():
    from repro_torch.launch.serve import main
    res = main(["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert res["generated"].shape == (2, 3)
    assert res["routes"].shape == (3, 32)
    assert res["cfg"] == TCFG.get_smoke("granite-3-8b")


def test_launcher_arch_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    out = _launch("--arch", "granite-3-8b", "--smoke")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    cfg = TCFG.get_smoke("granite-3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, T.init(cfg, 0, "cpu"), batch_size=1, max_seq=8)
