"""The yardstick's arithmetic on hand-worked cases, and the analytic
counts against the program's static profiler at a small size."""
import dataclasses

import numpy as np
import pytest
import torch

from synbench.core import peaks, roofline, stats
from synbench.core.spans import Spans
from synbench.core.trace import DeviceOp, Timeline
from synbench.reference import emulation, mamba2, qwen2
from synbench.core import spec


def test_roofline_hand_worked():
    # 67e12 operations take 1 s at the fp32 peak; 3.35e12 bytes 1 s of HBM
    assert roofline.bound_s(67e12, 1e12, peaks.FP32_FLOPS,
                            peaks.HBM_BYTES_PER_S) == pytest.approx(1.0)
    assert roofline.bound_s(1e12, 6.7e12, peaks.FP32_FLOPS,
                            peaks.HBM_BYTES_PER_S) == pytest.approx(2.0)
    assert roofline.share(1.0, 4.0) == pytest.approx(25.0)
    assert roofline.share(1.0, 0.0) is None
    assert roofline.share(0.0, 1.0) is None


def test_mfu_readers_hand_worked():
    from types import SimpleNamespace as NS
    mfu = spec.load_reader("serve_mfu")
    # 989e12 useful operations in a 2 s window: 50% of the bf16 peak
    run = NS(facts={"requests": 4, "useful_flops": 989e12}, window_s=2.0,
             timeline=None, spans=Spans())
    assert mfu.read(run) == pytest.approx(50.0)
    em = spec.load_reader("emulate_mfu.decode")
    run = NS(facts={"requests": 3, "roofline_s": 0.5}, window_s=2.0,
             timeline=None, spans=Spans())
    assert em.read(run) == pytest.approx(25.0)
    run.facts = {"requests": 0, "roofline_s": 0.0}
    assert em.read(run) is None


def test_timeline_busy_idle_and_gaps():
    sp = Spans()
    sp.done = [("window", 0, 100), ("wave", 10, 60)]
    ops = [DeviceOp("k1", 10, 30), DeviceOp("k2", 20, 40),
           DeviceOp("k1", 70, 80)]
    t = Timeline(ops, 0, 100, sp)
    assert t.busy_s() == pytest.approx(40e-9)
    assert t.idle_share() == pytest.approx(60.0)
    assert dict(map(tuple, t.by_name())) == pytest.approx(
        {"k1": 30e-9, "k2": 20e-9})
    gaps = dict(map(tuple, t.idle_gaps()))
    # gaps [0, 10) and [80, 100) in the window, [40, 70) in the wave
    assert gaps == pytest.approx({"window": 30e-9, "wave": 30e-9})


def test_percentile():
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_qwen2_counts_hand_worked():
    cfg = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1,
           "num_attention_heads": 2, "num_key_value_heads": 1,
           "vocab_size": 10, "rms_norm_eps": 1e-6, "rope_theta": 1e4,
           "tie_word_embeddings": False}
    s = qwen2.prefill_samples(cfg, 1, 3)
    # q 2*3*8*8, k, v 2*3*8*4 each, o 2*3*8*8, MLP 3 * 2*3*8*16,
    # scores and p·v 2 * 2*2*3*3*4 (2 query heads, 3 x 3 pairs, hd 4)
    lin = 384 + 192 + 192 + 384 + 3 * 768
    att = 2 * (2 * 1 * 6 * 4 * 3)
    assert s[1][0] == lin + att and s[0] == (0, 0)
    assert s[-1] == (2 * 8 * 10, 2 * (8 + 80 + 10))
    f, b = qwen2.flash_launch(cfg, 1, 3)
    assert f == 4 * 4 * 2 * 6 and b == 2 * (2 * 2 * 3 * 4 + 2 * 3 * 4)
    assert qwen2.request_flops(cfg, 3) == lin + 4 * 4 * 2 * 6 + 160


def _port_costs(name, S, T):
    """The program's static profiler on meta tensors at the rehearsal
    size: (prefill profile, cost, decode profile, cost)."""
    from repro_torch.configs.run import SERVE_RUN
    from repro_torch.core import profile_step
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    from synbench.runners.common import port_config
    root = spec.HERE.rsplit("/", 1)[0]
    cell = spec.resolve(root, name, rehearse=True)
    cfg = port_config(cell, cell.reference(), True)
    model = build_model(cfg, dataclasses.replace(SERVE_RUN,
                                                 attn_impl="full"))
    params = model.abstract()
    meta = torch.device("meta")
    pre = make_prefill_step(model, T)

    def pf(p, b):
        with torch.inference_mode():
            return pre(p, b)
    p1, c1 = profile_step(pf, params, {"tokens": torch.zeros(
        (1, S), dtype=torch.int32, device=meta)}, command="p", device="meta")
    dec = make_decode_step(model)

    def df(p, t, c):
        with torch.inference_mode():
            return dec(p, t, c)
    p2, c2 = profile_step(df, params, torch.zeros((1, 1), dtype=torch.int32,
                                                  device=meta),
                          model.init_cache(1, T, device=meta),
                          command="d", device="meta")
    return cell, p1, c1, p2, c2


@pytest.mark.parametrize("name,S", [("qwen2-7b.emulate_prompts", 16),
                                    ("qwen2-7b.emulate_prompts", 40),
                                    ("mamba2-780m.emulate_decode", 8),
                                    ("mamba2-780m.emulate_decode", 20)])
def test_analytic_counts_equal_the_static_profilers(name, S):
    cell, p1, c1, p2, c2 = _port_costs(name, S, S + 5)
    ref = cell.reference()
    want = ref.prefill_samples(cell.sizes, 1, S)
    assert c1.dot_flops == sum(w[0] for w in want)
    assert [s.resources.hbm_bytes for s in p1.samples] == \
        [float(w[1]) for w in want]
    want = ref.decode_samples(cell.sizes, 1, S + 5)
    assert c2.dot_flops == sum(w[0] for w in want)
    assert [s.resources.hbm_bytes for s in p2.samples] == \
        [float(w[1]) for w in want]


def test_mamba2_vocab_padding():
    c = spec.load_json(f"{spec.HERE}/configs/mamba2-780m.json")["config"]
    assert mamba2.dims(c)["V"] == 50288                  # as published
    assert mamba2.dims(dict(c, pad_vocab_size_multiple=8))["V"] == 50280


def test_emulation_table_and_fold_hand_worked():
    from types import SimpleNamespace as NS

    def smp(f, b):
        return NS(resources=NS(flops=f, hbm_bytes=b, ici_bytes={},
                               storage_read_bytes=0.0,
                               storage_write_bytes=0.0))
    tile, block = 4, 8               # 128 operations, 16 bytes a step
    samples = [smp(0.0, 0.0)] + [smp(300.0, 40.0)] * 3 + [smp(64.0, 8.0)]
    rs = emulation.runs(samples)
    assert rs == [(0.0, 0.0, 1), (300.0, 40.0, 3), (64.0, 8.0, 1)]
    # 900 / 128 = 7.03 -> 7; 120 / 16 = 7.5 -> 8 (to even); 0.5 -> 0
    assert emulation.table(rs, tile, block).tolist() == \
        [[0, 0, 0], [7, 8, 0], [0, 0, 0]]
    assert emulation.fold(rs) == (964.0, 128.0)
    assert emulation.rows_bound_s(rs, 100.0, 10.0) == pytest.approx(
        max(9.0, 12.0) + max(0.64, 0.8))
    assert emulation.roofline_s(samples, 100.0, 10.0) == pytest.approx(
        3 * 4.0 + 0.8)


def test_ring_values_fast_equals_the_loop():
    for slots, passes in ((13, 0), (13, 7), (13, 5001), (1, 3000)):
        assert (emulation.ring_values(slots, passes)
                == emulation.ring_values_fast(slots, passes)).all()
    assert emulation.ring_values(2, 3).tolist() == [
        np.float32(np.float32(1.0000001) * np.float32(1.0000001)),
        np.float32(1.0000001)]


def test_burn_reaches_its_fixed_point():
    y = emulation.burn(64, 1000, "cpu")
    nxt = (y @ (torch.eye(64) * 0.5)) * 0.5 + 0.25
    assert torch.equal(nxt, y)
    assert torch.equal(emulation.burn(64, 1, "cpu"),
                       torch.eye(64) * 0.125 + 0.25)
