"""The plain float32 Mamba-2 forward (``reference.mamba2``): its chunked
SSD against its step-by-step recurrence, the program's prefill against
it at the rehearsal size, its count of a request's work, and its weight
tree against the program's at the published widths."""
import dataclasses
import os

import pytest
import torch

from synbench.core import spec
from synbench.reference import mamba2

ROOT = os.path.dirname(spec.HERE)
CELL = "mamba2-780m.serve_prefill_pool"


def _recurrence(x, dt, A, Bm, Cm):
    """The SSD as the paper's recurrence, one position at a time, float64:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t."""
    S, H, P = x.shape
    rep = H // Bm.shape[1]
    Bh, Ch = Bm.repeat_interleave(rep, 1), Cm.repeat_interleave(rep, 1)
    h = torch.zeros(H, P, Bm.shape[2], dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[t] * A)[:, None, None] + \
            (dt[t][:, None] * x[t])[:, :, None] * Bh[t][:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", h, Ch[t]))
    return torch.stack(ys)


@pytest.mark.parametrize("G,S,chunk", [(1, 37, 8), (1, 32, 8), (2, 29, 8),
                                       (2, 40, 16), (2, 5, 8)])
def test_the_chunked_scan_equals_the_recurrence(G, S, chunk):
    """Float64, so the two orders of summation agree to its rounding; a
    length that is not a multiple of the chunk is padded with dt = 0."""
    g = torch.Generator().manual_seed(S * 10 + G)
    H, P, N = 4, 3, 5
    f64 = dict(dtype=torch.float64, generator=g)
    x = torch.randn(S, H, P, **f64)
    dt = torch.nn.functional.softplus(torch.randn(S, H, **f64))
    A = -torch.exp(torch.randn(H, **f64))
    Bm, Cm = torch.randn(S, G, N, **f64), torch.randn(S, G, N, **f64)
    got = mamba2.ssd(x, dt, A, Bm, Cm, chunk)
    assert got.shape == (S, H, P)
    torch.testing.assert_close(got, _recurrence(x, dt, A, Bm, Cm),
                               rtol=1e-10, atol=1e-10)


def _program(cell, run):
    from repro_torch.models.model_zoo import build_model
    from synbench.runners.common import port_config
    return build_model(port_config(cell, cell.reference(), True), run)


@pytest.mark.parametrize("seed", [1, 2 ** 32 + 5])
def test_the_programs_prefill_logits_match_the_reference(seed):
    """The program in float32 at the cell's rehearsal size, with the
    benchmark's weights (``make_weights``), on left-padded rows of
    different lengths: every position's logits within 1e-4 of the
    reference row's spread (``logit_err``).  Both sides are float32 and
    differ only in the order of their sums (the program's chunk products
    and state loop against the reference's ``segsum`` form): 1.1e-6 is
    read; with the state between chunks dropped from the reference,
    0.06-0.16."""
    from repro_torch.configs.run import RunConfig
    from synbench.runners.serve import make_weights
    cell = spec.resolve(ROOT, CELL, rehearse=True)
    sizes = cell.sizes
    model = _program(cell, RunConfig(param_dtype="float32",
                                     compute_dtype="float32", remat="none"))
    w = make_weights(mamba2.weight_shapes(sizes), mamba2.weight_std, seed,
                     torch.device("cpu"), torch.float32)
    g = torch.Generator().manual_seed(seed)
    V = mamba2.dims(sizes)["V"]
    toks = torch.randint(0, V, (3, 45), generator=g)
    toks[1, :13] = 0                     # left padding, as the engine pads
    with torch.no_grad():
        hidden, _, _ = model.forward(
            w, {"tokens": toks.int()},
            cache=model.init_cache(3, 45, device="cpu"))
        got = model.logits(w, hidden).reshape(-1, V)
        ref = mamba2.head(w, torch.stack(mamba2.final_hidden(
            w, list(toks), sizes)), sizes).reshape(-1, V)
    assert max(mamba2.logit_err(got, ref)) < 1e-4


@pytest.mark.parametrize("seed", [7, 2 ** 32 + 7])
def test_step_sizes_and_decays_are_drawn_as_mamba_ssm_draws_them(seed):
    """``dt = softplus(dt_bias)`` log-uniform from 0.001 to 0.1 and ``A =
    exp(A_log)`` uniform from 1 to 16, each a function of the one normal
    draw (float32 here, so the bounds hold to its rounding)."""
    from synbench.runners.serve import make_weights
    shapes = {"layers": {"mamba": {"A_log": (48, 48), "dt_bias": (48, 48)}}}
    w = make_weights(shapes, mamba2.weight_std, seed, torch.device("cpu"),
                     torch.float32)["layers"]["mamba"]
    dt = torch.nn.functional.softplus(w["dt_bias"])
    A = torch.exp(w["A_log"])
    assert 1e-3 * 0.999 <= dt.min() and dt.max() <= 0.1 * 1.001
    assert 1.0 <= A.min() and A.max() <= 16.0 * 1.001
    # half of each below the middle of its range: 0.01 and 8.5
    assert 0.45 < float((dt < 0.01).float().mean()) < 0.55
    assert 0.45 < float((A < 8.5).float().mean()) < 0.55


@pytest.mark.parametrize("S", [1, 100, 256, 1152, 4096])
def test_request_flops_is_a_prefill_of_batch_1(S):
    sizes = spec.resolve(ROOT, CELL).sizes
    assert mamba2.request_flops(sizes, S) == sum(
        f for f, _ in mamba2.prefill_samples(sizes, 1, S))
    assert mamba2.flash_layers(sizes) == 0


def test_the_weight_tree_is_the_programs_at_published_widths():
    """On the meta device: the published 48 layers of 1536, nothing
    allocated."""
    from repro_torch.configs.run import SERVE_RUN
    from synbench.runners.common import port_config
    from repro_torch.models.model_zoo import build_model
    cell = spec.resolve(ROOT, CELL)
    model = build_model(port_config(cell, cell.reference(), False),
                        dataclasses.replace(SERVE_RUN, attn_impl="full"))
    tree = model.abstract()
    assert tree["embed"].device.type == "meta"
    shapes = mamba2.weight_shapes(cell.sizes)
    assert shapes["layers"]["mamba"]["in_proj"] == (48, 1536, 6448)
    assert mamba2.shapes_match(tree, shapes) is None
    shapes["layers"]["mamba"]["conv_b"] = (48, 3329)
    assert mamba2.shapes_match(tree, shapes) == "layers/mamba/conv_b"



@pytest.mark.card
def test_the_float32_program_matches_the_reference_at_published_widths(
        card):
    """The program in float32 on the card at the published 48 layers of
    1536, the benchmark's weights: two rows of 4096 positions (16 chunks
    of 256; the second left-padded with 1000 tokens 0), the last 8
    positions' logits within 1e-3 of the reference row's spread.  Both
    sides are float32 with TF32 off and differ in the order of their sums
    only; the bfloat16 program reads 0.1-0.3 (``PERF.md`` §2)."""
    from repro_torch.configs.run import RunConfig
    from synbench.runners.serve import make_weights
    cell = spec.resolve(ROOT, CELL)
    sizes = cell.sizes
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from repro_torch.models.model_zoo import build_model
        from synbench.runners.common import port_config
        model = build_model(port_config(cell, mamba2, False),
                            RunConfig(param_dtype="float32",
                                      compute_dtype="float32",
                                      remat="none"))
        w = make_weights(mamba2.weight_shapes(sizes), mamba2.weight_std, 5,
                         card, torch.float32)
        V = mamba2.dims(sizes)["V"]
        g = torch.Generator(device=card).manual_seed(5)
        toks = torch.randint(0, V, (2, 4096), generator=g, device=card)
        toks[1, :1000] = 0
        with torch.no_grad():
            hidden, _, _ = model.forward(
                w, {"tokens": toks.int()},
                cache=model.init_cache(2, 4096, device=card))
            got = model.logits(w, hidden[:, -8:]).reshape(-1, V)
            del hidden
            ref = mamba2.head(w, torch.stack([h[-8:] for h in
                                              mamba2.final_hidden(
                                                  w, list(toks.cpu()),
                                                  sizes)]),
                              sizes).reshape(-1, V)
        errs = mamba2.logit_err(got, ref)
        print("float32 program logit_err", max(errs))
        assert max(errs) < 1e-3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
