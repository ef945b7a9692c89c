"""The benchmark's yardstick on the CPU: the traffic from a seed and the
sample it checks, the operation and byte counts of each kernel's roofline
and of the model flops against hand counts, and the trace readers on a
made-up trace."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import flops, readers, spec, stats, trace  # noqa: E402
from bench.harness.drive import PrefillRunner  # noqa: E402
from bench.harness.weights import layout  # noqa: E402
from bench.rooflines import decode_attention, flash_attention  # noqa: E402
from bench.traffic.generator import (Tokens, block_counts,  # noqa: E402
                                     prefill_shapes, prompt_shares)

CELL = spec.load_cell("internlm2-1.8b.prefill-conv-8k")
MIX = CELL.traffic
DENSE = spec.model_config(CELL)


def test_same_seed_same_traffic_other_seed_same_sizes_other_order():
    seed = 2**31 + 5
    a = list(itertools.islice(prefill_shapes(MIX, seed), 60))
    b = list(itertools.islice(prefill_shapes(MIX, seed), 60))
    c = list(itertools.islice(prefill_shapes(MIX, seed + 1), 60))
    assert a == b and a != c
    for blk in range(4):
        got = sorted(a[15 * blk:15 * blk + 15])
        assert got == sorted(c[15 * blk:15 * blk + 15])
        assert got == sorted([(16, 512)] + [(8, 1024)] * 2
                             + [(4, 2048)] * 4 + [(2, 4096)] * 8)
    t1, t2 = Tokens(512, seed, "cpu"), Tokens(512, seed, "cpu")
    x, y = t1.next(2, 64), t2.next(2, 64)
    assert torch.equal(x, y) and x.dtype == torch.int32
    assert not torch.equal(t1.next(2, 64), x)
    assert int(x.min()) >= 0 and int(x.max()) < 512


def test_flash_counts_match_a_hand_count():
    # internlm2 at B 2, S 2048: H 16, K 8, hd 128, 24 layers, bf16
    f, b = flash_attention.work(DENSE, {"mode": "prefill", "B": 2,
                                        "S": 2048})
    pairs = 2048 * 2049 // 2
    assert f == 24 * 4 * 2 * 16 * 128 * pairs
    assert b == 24 * 2 * (2 * 2 * 2048 * 16 * 128 + 2 * 2 * 2048 * 8 * 128)
    assert flash_attention.work(DENSE, {"mode": "decode", "B": 2,
                                        "ctx": 9, "slots": 16}) == (0.0, 0.0)


def test_decode_counts_match_a_hand_count():
    call = {"mode": "decode", "B": 16, "ctx": 24577, "slots": 32768}
    f, b = decode_attention.work(DENSE, call)
    assert f == 24 * 4 * 16 * 16 * 128 * 24577
    assert b == 24 * (2 * (2 * 16 * 24577 * 8 * 128 + 2 * 16 * 16 * 128)
                      + 4 * 32768)


def test_model_flops_match_a_hand_count():
    # internlm2, one sequence of 4 tokens
    lin = 2 * (2048 * 2048 + 2 * 2048 * 1024 + 2048 * 2048) \
        + 2 * 3 * 2048 * 8192
    want = 4 * 24 * lin + 24 * 4 * 16 * 128 * 10 + 2 * 2048 * 92544
    assert flops.prefill_flops(DENSE, 1, 4) == want
    dec = 24 * (lin + 4 * 16 * 128 * 100) + 2 * 2048 * 92544
    assert flops.decode_flops(DENSE, 3, 100) == 3 * dec


def _view(ops, calls, window=(0, 1_000_000), window_calls=(), window_s=0.0):
    return trace.View(cfg=DENSE, calls=list(calls), ops=list(ops),
                      host=[("aten::mm", 0, 100), ("aten::add", 300, 390)],
                      window_ns=window, window_calls=list(window_calls),
                      window_s=window_s)


def test_readers_on_a_made_up_trace():
    call = {"mode": "prefill", "B": 2, "S": 2048}
    ops = [("flash_kernel_wgmma<128>", 0, 100_000),
           ("sm90_xmma_gemm_bf16", 100_000, 400_000),
           ("elementwise_kernel", 400_000, 450_000),
           ("Memcpy DtoH (Device -> Pageable)", 450_000, 460_000),
           ("vectorized_elementwise_kernel", 700_000, 800_000)]
    v = _view(ops, [call, call])
    assert readers.launches_per_call(v) == 2.0          # 4 kernels, 2 calls
    assert readers.elementwise_ms(v) == pytest.approx(0.15 / 2)
    assert readers.idle_share(v) == pytest.approx(100 * (1 - 0.56))
    f, b = flash_attention.work(DENSE, call)
    bound = max(2 * f / 989e12, 2 * b / 3.35e12)
    assert readers.roofline(v, "flash_attention") == pytest.approx(
        100 * bound / 1e-4)
    assert readers.roofline(v, "decode_attention") is None  # not traced
    w = _view(ops, [call], window_calls=[call] * 10, window_s=2.0)
    assert readers.mfu(w) == pytest.approx(
        100 * 10 * flops.call_flops(DENSE, call) / (989e12 * 2.0))
    bd = trace.breakdown(v)
    assert bd["device_ops"][0] == ["sm90_xmma_gemm_bf16", 3e-4]
    assert bd["idle_gaps"][0] == ["host (no op)", 2.4e-4]
    assert len(bd["idle_gaps"]) == 2


def test_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_prompt_shares_follow_the_lognormal():
    q = prompt_shares(MIX)
    assert sum(q) == pytest.approx(1.0)
    # quartiles at half and twice the median: a quarter in each bucket
    assert q == pytest.approx([0.25] * 4, abs=0.003)
    wide = dict(MIX, prompt_sigma=2.0)
    assert prompt_shares(wide)[0] > q[0] and prompt_shares(wide)[-1] > q[-1]


@pytest.mark.parametrize("change,why", [
    ({"block": 7}, "whole calls"),
    ({"token_budget": 8000}, "does not divide")])
def test_a_mix_that_makes_no_whole_calls_is_refused(change, why):
    with pytest.raises(ValueError, match=why):
        block_counts(dict(MIX, **change))


def test_the_check_sample_holds_every_length_and_fills_with_the_shortest():
    class Cfg:
        vocab_size = 512
    run = PrefillRunner(Cfg(), {}, MIX, 2**31 + 77, "cpu")
    run.calls = [(8192 // S, S, 0.0, 1.0, torch.zeros(8192 // S, S),
                  np.zeros(8192 // S, np.int64))
                 for _ in range(30) for S in (512, 1024, 2048, 4096)]
    items = run.check_items()
    lengths = [len(it.tokens) for it in items]
    assert lengths[:4] == [4096, 2048, 1024, 512]
    assert set(lengths[4:]) == {512}
    assert sum(lengths) <= MIX["check_tokens"] < sum(lengths) + 512
    assert len(items) >= 250
    again = PrefillRunner(Cfg(), {}, MIX, 2**31 + 77, "cpu")
    again.calls = run.calls
    assert [it.rows for it in again.check_items()] == [it.rows
                                                       for it in items]


def test_the_weights_refuse_a_model_the_reference_does_not_know():
    class Hybrid:
        name, family, ffn_type = "hybrid", "hybrid", "gelu"
    with pytest.raises(ValueError, match="no layout"):
        layout(Hybrid())
