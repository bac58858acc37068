"""Token counts above 256: the port against the JAX package at N = 257
(``deit_tiny_patch2_32``'s count) and N = 577 (the 384 presets').

The kernels' CUDA versions take any token count (the shared memory of a
block bounds their routes); on the CPU each public kernel function runs
its plain PyTorch version, held
here against the JAX Pallas kernels in interpret mode, as
tests/test_torch_kernels.py holds them at N <= 24:
  * K1: t bit-equal to ``masked_map_stats`` on the emitted map (the JAX
    op's too), s within 1e-6; against the JAX kernel each map entry and t
    within 4 bf16 ulps of their own value, out within 2 bf16 ulps of
    max|out| (``_bf16_ulps``; ``test_block_stats_plain_matches_jax_kernel``
    says why);
  * K2: t bit-equal and s within 1e-6 of the JAX kernel's;
  * K3: out within 1e-5 and the map within 1e-6 of the JAX kernel's, the
    map's pads exactly 0;
  * K5 (real 577 in NP 640, as the JAX package pads the 384 presets): the
    map within 1e-6 of the JAX kernel's, pads exactly 0 in both, out
    within 1e-5.
The PPNet eval forward runs on ``deit_micro_test`` with patches of 2
(24 channels, 2 heads, 3 blocks; 32 px -> 257 tokens, 48 px -> 577), the
prune at block 2 keeping 81, against the JAX forward with its default
gates (the XLA route on the CPU), under ROADMAP's contracts: fp32 the same
top-81, ``cls_token_attn`` within 1e-5, distances and logits within 1e-4;
bf16 speed at least 74 of the fp32 top-81 kept (the micro keep is the
production keep), the lowest fp32 rank dropped no lower than 64 or than
the JAX bf16 forward's own, and the logits within 2e-2 relative plus
2e-2 * max|logits| of JAX's bf16 forward on the samples whose selections
agree (the test's docstring says why).
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.core.config import PPNetConfig, backbone_preset
from protopformer_tpu.kernels import attention_core as j_ac
from protopformer_tpu.kernels import stats as j_stats
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.ops import rollout as j_roll
from protopformer_tpu_torch import kernels as t_kernels
from protopformer_tpu_torch.kernels import attention_core as t_ac
from protopformer_tpu_torch.kernels import stats as t_stats
from protopformer_tpu_torch.ops import rollout as t_roll
from tests.torch_port import (
    assert_tie_free,
    jax_params,
    port_model,
    to_np,
    topk_sets,
)

# the micro width at the two token counts: img 32 / 48 in patches of 2
TOKENS = {257: 32, 577: 48}
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(81,),
    use_global=True, global_proto_per_class=3,
)


def test_the_kernels_take_the_384_presets_token_counts():
    """No kernel has a fixed most token count any more (F9's repair): the
    CUDA wrappers' checks take the 384 presets (577 tokens), the 640 JAX
    pads them to, ``deit_tiny_patch2_32`` (257) and DeiT-Tiny/16 at 448
    and 512 px (785 and 1,025), and the kernels module names no MAX_N."""
    from protopformer_tpu_torch.core.config import backbone_preset as t_preset

    assert not hasattr(t_kernels, "MAX_N") and not hasattr(t_stats, "MAX_N")
    for name, kw, n in (("deit_base_patch16_384", {}, 577),
                        ("deit_base_distilled_patch16_384", {}, 577),
                        ("deit_tiny_patch2_32", {}, 257),
                        ("deit_tiny_patch16_224", {"img_size": 448}, 785),
                        ("deit_tiny_patch16_224", {"img_size": 512}, 1025)):
        assert t_preset(name, **kw).num_patches + 1 == n
    for n in (577, 640, 785, 1025):
        qkv = torch.zeros((2, n, 3 * 192), dtype=torch.bfloat16)
        assert t_ac._check_qkv("K", qkv, 3, (torch.bfloat16,)) == (2, n, 192)
        assert t_stats.check_map(torch.zeros((2, n, n))) == (2, n)


# --- the kernels' plain versions against the interpreted JAX kernels ----------

def _qkv(rng, B, N, C):
    return rng.normal(size=(B, N, 3 * C)).astype(np.float32)


def _bf16_ulps(x):
    """The bf16 ulp (2^-7 of the power of two below) of each entry."""
    return np.ldexp(1.0, np.frexp(np.abs(np.asarray(x, np.float64)))[1] - 8)


def assert_within_ulps(got, want, limit, what: str) -> None:
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    excess = err - limit
    assert (excess <= 0).all(), (
        f"{what}: {int((excess > 0).sum())} entries outside the limit, "
        f"largest error {err.max()!r}")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "speed"])
@pytest.mark.parametrize("N", [257, 577, 785])
def test_block_stats_plain_matches_jax_kernel(rng, N, exact):
    B, C, H = 1, 16, 2
    qkv = _qkv(rng, B, N, C)
    w_out, w_map, w_t, _ = j_ac.fused_attention_block_stats(
        jnp.asarray(qkv).astype(jnp.bfloat16), H, 0.9, exact_discard=exact,
        interpret=True,
    )
    out, fmap, t, s = t_ac.fused_attention_block_stats(
        torch.from_numpy(qkv).bfloat16(), H, 0.9, exact_discard=exact
    )
    assert fmap.shape == (B, N, N)
    want_t, want_s = t_roll.masked_map_stats(fmap, 0.9, exact_discard=exact)
    np.testing.assert_array_equal(to_np(t), to_np(want_t))
    np.testing.assert_allclose(to_np(s), to_np(want_s), atol=1e-6)
    j_map = jnp.asarray(to_np(fmap)).astype(
        jnp.float32 if exact else jnp.bfloat16)
    jt, js = j_roll.masked_map_stats(j_map, 0.9, exact_discard=exact)
    np.testing.assert_array_equal(to_np(t), to_np(jt))
    np.testing.assert_allclose(to_np(s), to_np(js), atol=1e-6)
    # against the JAX kernel: its fp32 dots of the bf16 q and k sum in
    # another order, so a bf16 logit may round the other way and move its
    # row's reciprocal, and with it every entry of the row by an ulp or
    # two (at most 3 of an entry's own bf16 ulp over seeds 0-2 at both
    # counts; out, a sum of such products, within one ulp of max|out|).
    # A map or out 5 % off fails either limit.
    got_map, want_map = to_np(fmap).astype(np.float64), to_np(w_map)
    assert_within_ulps(got_map, want_map, 4 * _bf16_ulps(want_map), "map")
    assert_within_ulps(to_np(t), to_np(w_t), 4 * _bf16_ulps(to_np(w_t)), "t")
    w_out = to_np(w_out).astype(np.float64)
    assert_within_ulps(to_np(out).astype(np.float64), w_out,
                       2 * _bf16_ulps(np.abs(w_out).max()), "out")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "speed"])
@pytest.mark.parametrize("N", [257, 577, 785])
def test_map_stats_plain_matches_jax_kernel(rng, N, exact):
    maps = rng.uniform(size=(2, N, N)).astype(np.float32)
    maps /= maps.sum(-1, keepdims=True)
    j_in, t_in = jnp.asarray(maps), torch.from_numpy(maps)
    if not exact:
        j_in, t_in = j_in.astype(jnp.bfloat16), t_in.bfloat16()
    want_t, want_s = j_stats.fused_map_stats(
        j_in, 0.9, exact_discard=exact, interpret=True
    )
    got_t, got_s = t_stats.fused_map_stats(t_in, 0.9, exact_discard=exact)
    np.testing.assert_array_equal(to_np(got_t), to_np(want_t))
    np.testing.assert_allclose(to_np(got_s), to_np(want_s), atol=1e-6)


def _policy(rng, B, N):
    pol = (rng.uniform(size=(B, N)) > 0.4).astype(np.float32)
    pol[:, 0] = 1.0
    return pol


@pytest.mark.parametrize("N,NP", [(257, 257), (577, 577), (577, 640),
                                  (785, 785), (785, 896)])
def test_mean_padded_plain_matches_jax_kernel(rng, N, NP):
    B, C, H = 1, 16, 2
    pad = ((0, 0), (0, NP - N))
    qkv = np.pad(_qkv(rng, B, N, C), pad + ((0, 0),))
    pol = np.pad(_policy(rng, B, N), pad)
    w_out, w_map = j_ac.fused_attention_mean_padded(
        jnp.asarray(qkv), jnp.asarray(pol), H, real_n=N,
        compute_dtype=jnp.float32, interpret=True,
    )
    out, fmap = t_ac.fused_attention_mean_padded(
        torch.from_numpy(qkv), torch.from_numpy(pol), H, real_n=N
    )
    np.testing.assert_allclose(to_np(out)[:, :N], to_np(w_out)[:, :N],
                               atol=1e-5)
    np.testing.assert_allclose(to_np(fmap), to_np(w_map), atol=1e-6)
    assert np.abs(to_np(fmap)[:, N:]).max(initial=0.0) == 0.0
    assert np.abs(to_np(fmap)[:, :, N:]).max(initial=0.0) == 0.0


def test_core_padded_plain_matches_jax_kernel_at_577_in_640(rng):
    _core_padded_against_jax(rng, 577, 640)


def test_core_padded_plain_matches_jax_kernel_at_785_in_896(rng):
    """Real 785 in NP 896: DeiT-Tiny/16 at 448 px, padded to a multiple of
    128 as the JAX package pads, past 640 tokens."""
    _core_padded_against_jax(rng, 785, 896)


def _core_padded_against_jax(rng, N, NP):
    B, C, H = 1, 16, 2
    pad = ((0, 0), (0, NP - N))
    qkv = np.pad(_qkv(rng, B, N, C), pad + ((0, 0),))
    pol = np.pad(_policy(rng, B, N), pad)
    w_out, w_map = j_ac.fused_attention_core_padded(
        jnp.asarray(qkv), jnp.asarray(pol), H, N,
        compute_dtype=jnp.float32, interpret=True,
    )
    out, fmap = t_ac.fused_attention_core_padded(
        torch.from_numpy(qkv), torch.from_numpy(pol), H, N
    )
    got, want = to_np(fmap), to_np(w_map)
    np.testing.assert_allclose(got, want, atol=1e-6)
    for m in (got, want):
        assert np.abs(m[:, N:]).max() == 0.0 and np.abs(m[:, :, N:]).max() == 0.0
    np.testing.assert_allclose(to_np(out)[:, :N], to_np(w_out)[:, :N],
                               atol=1e-5)


# --- the PPNet eval forward ------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(TOKENS))
def micro(request):
    """deit_micro_test in patches of 2 at N tokens: seeded JAX weights, 2
    images, the JAX fp32 forward."""
    n = request.param
    bk = backbone_preset("deit_micro_test", patch_size=2,
                         img_size=TOKENS[n])
    assert bk.num_patches + 1 == n
    params = jax_params(bk, PP, seed=3)
    x = np.random.default_rng(n).normal(
        size=(2, bk.img_size, bk.img_size, 3)).astype(np.float32)
    fp32 = jax.jit(j_construct(bk, PP).apply)({"params": params},
                                             jnp.asarray(x))
    return dict(n=n, backbone=bk, params=params, x=x, fp32=fp32)


def test_ppnet_fp32_matches_jax_past_640_tokens():
    """F9's CPU side: the port's PPNet at ``deit_micro_test`` in patches of
    2 at 56 px (785 tokens, as DeiT/16 at 448 px) in fp32 against the JAX
    package's default forward: the same top-81 tokens, ``cls_token_attn``
    within 1e-5, distances and logits within 1e-4."""
    bk = backbone_preset("deit_micro_test", patch_size=2, img_size=56)
    assert bk.num_patches + 1 == 785
    params = jax_params(bk, PP, seed=3)
    x = np.random.default_rng(785).normal(size=(2, 56, 56, 3)).astype(
        np.float32)
    want = jax.jit(j_construct(bk, PP).apply)({"params": params},
                                              jnp.asarray(x))
    got = _port_forward(dict(params=params, x=x), bk, torch.float32)
    want_attn = to_np(want.cls_token_attn)
    assert want_attn.shape == (2, 784)
    assert_tie_free(want_attn, 81)
    assert topk_sets(to_np(got.cls_token_attn), 81) == topk_sets(want_attn, 81)
    np.testing.assert_allclose(to_np(got.cls_token_attn), want_attn,
                               atol=1e-5)
    for field in ("distances", "logits", "logits_global", "logits_local"):
        np.testing.assert_allclose(to_np(getattr(got, field)),
                                   to_np(getattr(want, field)), atol=1e-4,
                                   rtol=1e-4, err_msg=field)


def _port_forward(m, backbone, dtype):
    model = port_model(backbone, PP, m["params"], dtype)
    with torch.inference_mode():
        return model(torch.from_numpy(m["x"]))


def test_ppnet_fp32_matches_jax(micro):
    m = micro
    got, want = _port_forward(m, m["backbone"], torch.float32), m["fp32"]
    want_attn = to_np(want.cls_token_attn)
    assert want_attn.shape == (2, m["n"] - 1)
    assert_tie_free(want_attn, 81)
    assert topk_sets(to_np(got.cls_token_attn), 81) == topk_sets(want_attn, 81)
    np.testing.assert_allclose(to_np(got.cls_token_attn), want_attn,
                               atol=1e-5)
    for field in ("distances", "logits", "logits_global", "logits_local"):
        g, w = to_np(getattr(got, field)), to_np(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=field)


def test_ppnet_bf16_speed_selection_and_logits(micro):
    """bf16 speed against the JAX package's own bf16 speed forward on the
    same inputs. The rank clause (drops only at fp32 rank >= 64) was set at
    DeiT-Tiny/16@224's width; at this micro width the JAX package's bf16
    forward itself drops fp32 ranks below 64 (56 at 257 tokens, 59 at 577
    on these seeds), so the port's lowest dropped rank is held to the
    smaller of 64 and JAX's. The logits are compared on the samples whose
    two bf16 selections are the same token set: a different set changes the
    prototype evidence, not the arithmetic."""
    m = micro
    bk = dataclasses.replace(m["backbone"], rollout_exact_discard=False)
    got = _port_forward(m, bk, torch.bfloat16)
    want = jax.jit(j_construct(bk, PP, compute_dtype=jnp.bfloat16).apply)(
        {"params": m["params"]}, jnp.asarray(m["x"]))
    fp32_order = np.argsort(-to_np(m["fp32"].cls_token_attn), axis=-1)
    got_sets = topk_sets(to_np(got.cls_token_attn), 81)
    jax_sets = topk_sets(to_np(want.cls_token_attn), 81)
    for b, (got_set, jax_set) in enumerate(zip(got_sets, jax_sets)):
        want_set = set(fp32_order[b, :81].tolist())
        assert len(want_set & got_set) >= 74, f"sample {b}"
        rank = {int(tok): r for r, tok in enumerate(fp32_order[b])}
        floor = min([64] + [rank[t] for t in want_set - jax_set])
        assert all(rank[t] >= floor for t in want_set - got_set), f"sample {b}"
    same = np.array([g == j for g, j in zip(got_sets, jax_sets)])
    assert same.any()
    logits, want_logits = to_np(got.logits), to_np(want.logits)
    np.testing.assert_allclose(
        logits[same], want_logits[same], rtol=2e-2,
        atol=2e-2 * float(np.abs(want_logits).max()),
    )


def test_time_long_kernels_copies_the_package_with_the_parents_kernels(
        tmp_path, monkeypatch):
    """``cli.time_long_kernels`` times a copy of the package whose
    ``csrc/`` is an unpacked parent tree's and whose Python is this
    checkout's; a tree without kernel sources raises, and so does a run
    without a card."""
    from protopformer_tpu_torch.cli import time_long_kernels as tl

    monkeypatch.setattr(tl, "PARENT_COPY", tmp_path / "copy")
    src = tl.ROOT / "protopformer_tpu_torch"
    parent = tmp_path / "parent"
    (parent / "protopformer_tpu_torch" / "csrc").mkdir(parents=True)
    sources = {"common.cuh": "// the parent's header\n",
               "attention_mean.cu": "// the parent's K3\n"}
    for name, text in sources.items():
        (parent / "protopformer_tpu_torch" / "csrc" / name).write_text(text)
    copy = tl.make_parent(parent) / "protopformer_tpu_torch"
    assert {p.name: p.read_text() for p in (copy / "csrc").iterdir()} == (
        sources)
    assert not list(copy.rglob("__pycache__"))
    for path in src.rglob("*.py"):
        if "__pycache__" not in path.parts:
            rel = path.relative_to(src)
            assert (copy / rel).read_bytes() == path.read_bytes(), rel
    with pytest.raises(RuntimeError, match="no kernel sources"):
        tl.make_parent(tmp_path / "missing")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            tl.run(parent)


def test_time_long_kernels_models_are_their_token_counts():
    """``cli.time_long_kernels`` serves each model of ``MODELS`` at the token
    count of its tag: DeiT-Tiny/16 at 448 and 512 px reach 785 and 1,025
    tokens, past 640, beside the 577 and 257 readings."""
    from protopformer_tpu_torch.cli import time_long_kernels as tl
    from protopformer_tpu_torch.core.config import backbone_preset

    for at, (preset, overrides) in tl.MODELS.items():
        cfg = backbone_preset(preset, **overrides)
        assert at == f"N={cfg.num_patches + 1}", preset
    assert {"N=577", "N=257", "N=785", "N=1025"} <= set(tl.MODELS)


def test_time_long_kernels_thresh_and_bench_readings(monkeypatch):
    """The readings ``cli.time_long_kernels`` takes beside the serving ones,
    rehearsed on the CPU at B=2 (the plain versions, the host clock):
    the bf16 exact ``masked_forward_thresh`` of ``deit_tiny_patch2_32``
    (its img/s, K4, K4's attention phase and its normalize on the first K4
    call's operands), K5 and its attention phase on the kernel bench's
    operands at 577 and 785 tokens (and K5's normalize at 785) and K3 on
    them at 257, each case held against its plain version before it is
    timed."""
    from protopformer_tpu_torch.cli import bench_kernels
    from protopformer_tpu_torch.cli import time_long_kernels as tl
    from protopformer_tpu_torch.core.config import PPNetConfig, backbone_preset
    from protopformer_tpu_torch.models import construct_ppnet

    monkeypatch.setattr(tl, "B", 2)
    small = bench_kernels.bench_inputs
    monkeypatch.setattr(bench_kernels, "bench_inputs",
                        lambda dev, tokens: small(dev, batch=2, tokens=tokens))
    cfg = backbone_preset("deit_tiny_patch2_32")
    ppnet = PPNetConfig()
    state_dict = construct_ppnet(
        cfg, ppnet, torch.float32,
        generator=torch.Generator().manual_seed(10)).state_dict()
    cpu = torch.device("cpu")
    got = tl.thresh_readings(cfg, ppnet, state_dict, cpu)
    got.update(tl.bench_readings(cpu))
    assert set(got) == {"K3[bf16,thresh,N=257,H=3]", "K4[bf16,thresh,N=257,H=3]",
                        "K4_normalize[bf16,thresh,N=257]",
                        "img_per_sec[thresh_bf16_exact,N=257]",
                        "K3[bf16,bench,577 in 640]",
                        "K5[bf16,bench,577 in 640]",
                        "K3[bf16,bench,785 in 896]",
                        "K5[bf16,bench,785 in 896]",
                        "K5_normalize[bench,785 in 896]",
                        "K3[bf16,bench,257]"}
    # a normalize is a difference of two host-clock times
    assert all(v > 0 for k, v in got.items() if "normalize" not in k)
    assert all(math.isfinite(v) for v in got.values())


def test_time_long_kernels_short_readings(monkeypatch):
    """The readings ``cli.time_long_kernels`` takes at N <= 256, rehearsed on
    the CPU at B=2 (the plain versions, the host clock): K1 in both modes
    and K2 on K1's exact map at each of ``SHORT_CASES``, and K5 with its
    attention phase and its normalize on the kernel bench's operands at
    197 and 256 tokens, each case held against its plain version before it
    is timed."""
    from protopformer_tpu_torch.cli import bench_kernels
    from protopformer_tpu_torch.cli import time_long_kernels as tl

    monkeypatch.setattr(tl, "B", 2)
    small = bench_kernels.bench_inputs
    monkeypatch.setattr(bench_kernels, "bench_inputs",
                        lambda dev, tokens: small(dev, batch=2, tokens=tokens))
    got = tl.short_readings(torch.device("cpu"))
    want = set()
    for n, _c, h in tl.SHORT_CASES:
        want |= {f"K1[speed,N={n},H={h}]", f"K1[exact,N={n},H={h}]",
                 f"K2[fp32,N={n},H={h}]"}
    for at in ("bench,197 in 256", "bench,256 in 256"):
        want |= {f"K3[bf16,{at}]", f"K5[bf16,{at}]", f"K5_normalize[{at}]"}
    assert set(got) == want
    # the normalize is a difference of two host-clock times
    assert all(v > 0 for k, v in got.items() if "normalize" not in k)
    assert all(math.isfinite(v) for v in got.values())
