"""The decode step's position on the device, on the CPU: a (1,) int32
tensor ``pos`` gives the same bits as the host int it holds, in the plain
decode attention (``ref.decode_attention_cache``, ``ops.decode_attention``),
in ``attention.decode_attention``'s cache write (the K/V rows and
``slot_pos``, the window's wrap and the clamp at W - 1) and in
``decoder_decode`` over several steps of the dense and MoE smokes.  The
serving engine passes such a tensor on the card, where its decode step is
a CUDA graph; on the CPU it steps eagerly with a host int, captures
nothing, and serves the tokens of a hand loop that decodes at a tensor
position.  The card's side is in ``tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.transformer import decoder_prefill_with_cache
from repro_torch.serve import engine as tengine

DENSE, MOE = "internlm2-1.8b", "qwen3-moe-30b-a3b"


def _randn(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        *shape).astype(np.float32)).to(dtype)


def _at(pos: int) -> torch.Tensor:
    return torch.tensor([pos], dtype=torch.int32)


def _slot_pos(W: int, pos: int, window: int) -> torch.Tensor:
    """The slots a decode at ``pos`` finds: positions 0..pos-1 written at
    ``p % W`` with a window (a ring), at ``p`` without; -1 elsewhere."""
    sp = torch.full((W,), -1, dtype=torch.int32)
    for p in range(pos):
        if window or p < W:
            sp[p % W if window else p] = p
    return sp


@pytest.mark.parametrize("fn", [ref.decode_attention_cache,
                                ops.decode_attention],
                         ids=["ref", "ops"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("pos,window", [(50, 0), (50, 24), (90, 32)])
def test_decode_attention_tensor_position_equals_int(fn, dtype, pos,
                                                     window):
    B, H, K, W, hd = 2, 4, 2, 64, 16
    q = _randn(1, B, H, hd, dtype=dtype)
    k, v = (_randn(s, B, W, K, hd, dtype=dtype) for s in (2, 3))
    sp = _slot_pos(W, pos, window)
    want = fn(q, k, v, sp, pos, window=window)
    got = fn(q, k, v, sp, _at(pos), window=window)
    assert torch.equal(got, want)
    assert want.abs().sum() > 0


@pytest.mark.parametrize("switch", [False, True], ids=["sdpa", "kernels"])
@pytest.mark.parametrize("W,pos,window", [
    (16, 5, 0),       # a slot of its own
    (16, 15, 0),      # the last slot
    (16, 21, 0),      # past the cache: clamped to W - 1
    (16, 21, 8),      # a window: wrapped to pos % W
    (16, 37, 16)])    # wrapped twice
def test_decode_attention_cache_write_tensor_position_equals_int(
        switch, W, pos, window):
    cfg = get_smoke(DENSE).with_(use_flash_kernel=switch)
    B, d = 2, cfg.d_model
    p = {k: _randn(10 + i, d, n) * 0.1 for i, (k, n) in enumerate(
        (("wq", cfg.n_heads * cfg.hd), ("wk", cfg.n_kv_heads * cfg.hd),
         ("wv", cfg.n_kv_heads * cfg.hd)))}
    p["wo"] = _randn(13, cfg.n_heads * cfg.hd, d) * 0.1
    x = _randn(14, B, 1, d)
    base = attn.KVCache(_randn(15, B, W, cfg.n_kv_heads, cfg.hd),
                        _randn(16, B, W, cfg.n_kv_heads, cfg.hd),
                        _slot_pos(W, pos, window))
    runs = []
    for at in (pos, _at(pos)):
        cache = attn.KVCache(*(t.clone() for t in base))
        out, back = attn.decode_attention(p, cfg, x, cache, at, window)
        assert all(a is b for a, b in zip(back, cache))    # in place
        runs.append((out, cache))
    (want, wc), (got, gc) = runs
    assert torch.equal(got, want)
    for a, b in zip(gc, wc):
        assert torch.equal(a, b)
    slot = min(pos % W if window else pos, W - 1)
    assert int(gc.slot_pos[slot]) == pos
    assert not torch.equal(gc.k[:, slot], base.k[:, slot])
    rest = [i for i in range(W) if i != slot]
    assert torch.equal(gc.k[:, rest], base.k[:, rest])
    assert torch.equal(gc.slot_pos[rest], base.slot_pos[rest])


@pytest.mark.parametrize("arch", [DENSE, MOE])
@pytest.mark.parametrize("switch", [False, True], ids=["sdpa", "kernels"])
def test_decoder_decode_tensor_position_equals_int(arch, switch):
    cfg = get_smoke(arch).with_(use_flash_kernel=switch)
    params = tserve.build_params(cfg, seed=3, device="cpu")
    B, W, P = 3, 24, 8
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32))
    with torch.no_grad():
        lg, cache = decoder_prefill_with_cache(params, cfg, toks, W)
        caches = [attn.KVCache(*(t.clone() for t in cache))
                  for _ in range(2)]
        tok = [torch.argmax(lg, -1).to(torch.int32)] * 2
        for pos in range(P, P + 6):
            outs = []
            for i, at in enumerate((pos, _at(pos))):
                lg, caches[i] = M.decode(params, cfg, tok[i], caches[i], at)
                outs.append(lg)
                tok[i] = torch.argmax(lg, -1).to(torch.int32)
            assert torch.equal(outs[1], outs[0]), pos
    for a, b in zip(*caches):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_cpu_engine_captures_nothing_and_serves_a_tensor_position_loop(
        arch):
    """On the CPU the engine steps eagerly (no graph, no replay) and its
    tokens for one request are those of a hand loop over
    ``make_decode_step`` at a tensor position."""
    from repro_torch.serve.decode import make_decode_step
    cfg = get_smoke(arch)
    params = tserve.build_params(cfg, seed=5, device="cpu")
    P, W, new = 12, 40, 9
    prompt = np.random.RandomState(6).randint(
        0, cfg.vocab_size, P).astype(np.int32)
    eng = tengine.Engine(params, cfg, batch=1, n_slots=W, prefill_len=P,
                         device="cpu")
    req = tengine.Request(0, prompt, max_new=new)
    eng.submit(req)
    stats = eng.run()
    assert req.done and stats.decode_steps == new - 1
    assert eng.captures == 0 and eng.replays == 0 and eng._graph is None
    step = make_decode_step(cfg)
    with torch.no_grad():
        lg, cache = decoder_prefill_with_cache(
            params, cfg, torch.from_numpy(prompt)[None], W)
        tok = torch.argmax(lg, -1).to(torch.int32)
        want = [int(tok[0])]
        for pos in range(P, P + new - 1):
            tok, cache = step(params, tok, cache, _at(pos))
            want.append(int(tok[0]))
    assert req.generated == want
