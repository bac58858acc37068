"""The port's training (``protopformer_tpu_torch/train``, the train forward
of the models, ``ops/ppc.py``) against the JAX package.

Micro geometry of ``tests/test_torch_model.py`` (img 32, patch 8, dim 24,
depth 3, heads 2, discard 0.7 for trap F2; 40 prototypes x 16, 4 classes,
reserve 9 at block 2, 3 global per class; CaiT: 2 class-attention blocks,
reserve 9 at 1), drop path 0 where values are compared. The same seeded
JAX weights go through ``state_dict_from_jax``; JAX gradients map onto
the port's parameters with the same converter (the layout maps are
transposes). Contracts:
  * fp32 train-forward CE gradients: loss within 1e-5, every parameter
    within 2e-4 * max|g| + 1e-7; ``ones`` and the frozen heads get none;
  * ``ppc_loss`` and its gradient within 1e-5; ``scatter_tokens_to_grid``
    bit-equal; ``gelu_exact``'s backward within 1e-6 of ``jax.jvp``;
  * optimizer steps (three groups, EMA) within 1e-6 of optax; schedules
    within rtol 2e-6 at every epoch boundary (JAX evaluates them in fp32,
    the port in float64 as timm does: a few fp32 ulps apart);
  * bf16 train forward: at least 8 of JAX's fp32 top-9 tokens kept (74/81
    at 224), drops only at fp32 rank >= 7 (64/81), logits within rtol
    2e-2 plus 2e-2 * max|logits| of JAX's bf16 train forward.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from protopformer_tpu.core import config as j_config
from protopformer_tpu.core.config import (
    OptimConfig,
    PPNetConfig,
    backbone_preset,
)
from protopformer_tpu.models import construct_ppnet as j_construct
from protopformer_tpu.train import create_train_state as j_create_state
from protopformer_tpu.train import make_optimizer as j_make_optimizer
from protopformer_tpu_torch import train as t_train
from protopformer_tpu_torch.checkpoint import state_dict_from_jax
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.models import TrainOutput
from protopformer_tpu_torch.models import layers as t_layers
from tests.torch_port import (
    assert_tie_free,
    jax_params,
    port_configs,
    port_model,
    to_np,
    topk_sets,
)

DEIT = dataclasses.replace(
    backbone_preset("deit_micro_test"), name="tiny-test",
    rollout_discard_ratio=0.7, drop_path_rate=0.0,
)
CAIT = dataclasses.replace(
    backbone_preset("cait_micro_test"), rollout_discard_ratio=0.7,
    drop_path_rate=0.0,
)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)
PP_CAIT = dataclasses.replace(PP, reserve_layers=(1,))
GEOMETRY = {"deit": (DEIT, PP), "cait": (CAIT, PP_CAIT)}
OPT = OptimConfig(epochs=10, warmup_epochs=2, warmup_lr=1e-4,
                  features_lr=1e-3, add_on_layers_lr=3e-3,
                  prototype_vectors_lr=3e-3, model_ema=True,
                  model_ema_decay=0.9)
FROZEN = ("ones", "last_layer.weight", "last_layer_global.weight")


def _port_optim(cfg):
    return t_config.OptimConfig(**dataclasses.asdict(cfg))


def _state_dict(tree, bk):
    return state_dict_from_jax(tree, bk.arch, bk.depth,
                               PP.global_proto_per_class, bk.depth_token_only)


def _ce(logits, labels):
    return -jnp.mean(jnp.sum(
        jax.nn.log_softmax(logits) * jax.nn.one_hot(labels, 4), axis=-1))


@pytest.fixture(scope="module")
def weights():
    """Seeded JAX weights per arch, 4 images and their labels."""
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 3)).astype(np.float32)
    return {arch: jax_params(bk, pp, seed=0)
            for arch, (bk, pp) in GEOMETRY.items()}, x, np.array([0, 2, 1, 3])


def _port(arch, params, dtype=torch.float32, **overrides):
    bk, pp = GEOMETRY[arch]
    return port_model(dataclasses.replace(bk, **overrides), pp, params, dtype)


# --- F7 and configuration ----------------------------------------------------

def test_unknown_arch_raises_like_jax():
    from protopformer_tpu.models import create_backbone as j_create
    from protopformer_tpu_torch.models import create_backbone as t_create

    vit = dataclasses.replace(DEIT, arch="vit")
    with pytest.raises(ValueError, match="unknown backbone arch: vit"):
        j_create(vit)
    with pytest.raises(ValueError, match="unknown backbone arch: vit"):
        t_create(port_configs(vit, PP)[0])
    with pytest.raises(ValueError, match="unknown backbone arch: vit"):
        state_dict_from_jax({"features": {}}, arch="vit", depth=3)


@pytest.mark.parametrize("cls", ["OptimConfig", "DataConfig", "TrainConfig",
                                 "ExperimentConfig"])
def test_train_configs_copy_the_jax_fields(cls):
    j_fields = dataclasses.fields(getattr(j_config, cls))
    t_fields = dataclasses.fields(getattr(t_config, cls))
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    if cls != "ExperimentConfig":
        want = dataclasses.asdict(getattr(j_config, cls)())
        assert dataclasses.asdict(getattr(t_config, cls)()) == want


# --- ops ---------------------------------------------------------------------

def test_gelu_exact_backward_is_the_jax_jvp(rng):
    """The analytic Phi(x) + x * phi(x), not autograd through A&S."""
    from protopformer_tpu.ops.activations import gelu_exact as j_gelu
    from protopformer_tpu_torch.ops.activations import gelu_exact

    x = (rng.normal(size=(4096,)) * 3).astype(np.float32)
    x[:3] = (0.0, -1e-3, 8.0)
    ct = rng.normal(size=x.shape).astype(np.float32)
    y_j, dy_j = jax.jvp(j_gelu, (jnp.asarray(x),), (jnp.asarray(ct),))
    xt = torch.from_numpy(x).requires_grad_()
    y = gelu_exact(xt)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-6, rtol=0)
    # elementwise, so the VJP with cotangent ct is the JVP with tangent ct
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dy_j),
                               atol=1e-6, rtol=0)


def test_scatter_tokens_to_grid_is_an_exact_copy(rng):
    from protopformer_tpu.ops.tokens import scatter_tokens_to_grid as j_scatter
    from protopformer_tpu_torch.ops.tokens import scatter_tokens_to_grid

    values = rng.normal(size=(3, 5, 9)).astype(np.float32)
    idx = np.sort(np.stack([rng.permutation(16)[:9] for _ in range(3)]), -1)
    want = np.asarray(j_scatter(jnp.asarray(values), jnp.asarray(idx), 16))
    v = torch.from_numpy(values).requires_grad_()
    got = scatter_tokens_to_grid(v, torch.from_numpy(idx), 16)
    assert np.array_equal(got.detach().numpy(), want)
    ct = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    got.backward(ct)
    assert torch.equal(v.grad, torch.gather(
        ct, 2, torch.from_numpy(idx)[:, None, :].expand(3, 5, 9)))


def test_ppc_loss_and_gradient_match_jax(rng):
    from protopformer_tpu.ops.ppc import ppc_loss as j_ppc
    from protopformer_tpu_torch.ops.ppc import ppc_loss

    act = rng.uniform(0.0, 5.0, size=(3, 40, 9)).astype(np.float32)
    rollout = rng.uniform(size=(3, 16)).astype(np.float32)
    label = np.array([0, 3, 2])
    args = (4, 10, 4, 1.0, 2.0)

    def j_total(a):
        cov, mean = j_ppc(a, jnp.asarray(rollout), jnp.asarray(label), *args)
        return 0.1 * cov + 0.5 * mean, (cov, mean)

    (_, (j_cov, j_mean)), j_grad = jax.jit(jax.value_and_grad(
        j_total, has_aux=True))(jnp.asarray(act))
    a = torch.from_numpy(act).requires_grad_()
    cov, mean = ppc_loss(a, torch.from_numpy(rollout), torch.from_numpy(label),
                         *args)
    (0.1 * cov + 0.5 * mean).backward()
    assert float(j_cov) > 0 and float(j_mean) > 0  # both terms active
    np.testing.assert_allclose(cov.item(), float(j_cov), atol=1e-5)
    np.testing.assert_allclose(mean.item(), float(j_mean), atol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(j_grad), atol=1e-5,
                               rtol=0)


def test_cross_entropy_matches_jax():
    from protopformer_tpu.train import cross_entropy_loss as j_ce

    logits = np.array([[2.0, 0.0, -1.0], [0.5, 1.5, 0.1]], np.float32)
    hard = np.array([0, 2])
    soft = np.array([[0.7, 0.3, 0.0], [0.0, 0.2, 0.8]], np.float32)
    for labels in (hard, soft):
        for smoothing in (0.0, 0.1):
            want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels),
                              smoothing))
            got = float(t_train.cross_entropy_loss(
                torch.from_numpy(logits), torch.from_numpy(labels),
                smoothing))
            np.testing.assert_allclose(got, want, rtol=1e-6)


# --- the train forward and its gradients -------------------------------------

@pytest.mark.parametrize("arch", ["deit", "cait"])
def test_train_forward_gradients_match_jax(weights, arch):
    """CE of the fp32 train forward (``PPNet(train=True)``): the loss, the
    forward's outputs, ``get_ppc_loss`` on them and every parameter's
    gradient against ``jax.grad``; the frozen tensors get no gradient."""
    params, x, labels = weights
    bk, pp = GEOMETRY[arch]
    j_model = j_construct(bk, pp)

    def loss_fn(p):
        out = j_model.apply({"params": p}, jnp.asarray(x), train=True)
        return _ce(out.logits, jnp.asarray(labels)), out

    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params[arch])
    model = _port(arch, params[arch]).train()
    out = model(torch.from_numpy(x))
    loss = t_train.cross_entropy_loss(out.logits, torch.from_numpy(labels))
    loss.backward()

    assert isinstance(out, TrainOutput)
    assert out.original_fea_len == 16 and out.attn_loss.shape == ()
    assert not out.cls_attn_rollout.requires_grad
    assert_tie_free(to_np(j_out.cls_attn_rollout), 9)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    np.testing.assert_allclose(to_np(out.cls_attn_rollout),
                               to_np(j_out.cls_attn_rollout), atol=1e-5)
    np.testing.assert_allclose(to_np(out.total_proto_act.detach()),
                               to_np(j_out.total_proto_act), atol=1e-4,
                               rtol=1e-4)
    want_ppc = j_model.apply({"params": params[arch]}, j_out.total_proto_act,
                             j_out.cls_attn_rollout, jnp.asarray(labels),
                             method=j_model.get_ppc_loss)
    got_ppc = model.get_ppc_loss(out.total_proto_act.detach(),
                                 out.cls_attn_rollout,
                                 torch.from_numpy(labels))
    np.testing.assert_allclose([v.item() for v in got_ppc],
                               [float(v) for v in want_ppc], atol=1e-5)
    want = _state_dict(jax.tree.map(np.asarray, j_grads), bk)
    checked = 0
    for name, p in model.named_parameters():
        if name in FROZEN:
            assert p.grad is None and not p.requires_grad, name
            continue
        g = want[name].numpy()
        scale = max(float(np.abs(g).max()), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=2e-4 * scale + 1e-7, err_msg=name)
        checked += 1
    assert checked == len(want) - len(FROZEN)


def test_bf16_train_forward_selection_and_logits(weights):
    """The bf16 train forward (gather at the prune point, as in eval)
    against JAX's fp32 train forward for the selection and JAX's bf16 train
    forward for the logits."""
    params, x, _ = weights
    run = {dt: jax.jit(lambda p, im, dt=dt: j_construct(
        DEIT, PP, compute_dtype=dt).apply({"params": p}, im, train=True))(
        params["deit"], jnp.asarray(x)) for dt in (jnp.float32, jnp.bfloat16)}
    model = _port("deit", params["deit"], torch.bfloat16).train()
    assert model._gather_at_prune()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    fp32_attn = to_np(run[jnp.float32].cls_attn_rollout)
    fp32_order = np.argsort(-fp32_attn, axis=-1)
    for b, got_set in enumerate(topk_sets(to_np(got.cls_attn_rollout), 9)):
        want_set = set(fp32_order[b, :9].tolist())
        assert len(want_set & got_set) >= 8, f"sample {b}"
        rank = {int(t): r for r, t in enumerate(fp32_order[b])}
        assert all(rank[t] >= 7 for t in want_set - got_set), f"sample {b}"
    want = to_np(run[jnp.bfloat16].logits)
    np.testing.assert_allclose(to_np(got.logits), want, rtol=2e-2,
                               atol=2e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_train_forward_runs_k2_and_no_attention_kernel(monkeypatch, dtype):
    """Training mode: K2 once per pre-prune block (2 here, 11 at the
    preset), no attention kernel; eval mode keeps the serving routes."""
    from protopformer_tpu_torch.models import deit

    calls = {}

    def spy(module, fn):
        def wrapped(*args, **kwargs):
            calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, fn.__name__, wrapped)

    for fn in (t_layers.fused_attention_block_stats,
               t_layers.fused_attention_mean_padded,
               t_layers.fused_attention_core):
        spy(t_layers, fn)
    spy(deit, deit.fused_map_stats)
    from protopformer_tpu_torch.models import construct_ppnet

    net = construct_ppnet(*port_configs(DEIT, PP), dtype,
                          generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    net.train()(x).logits.sum().backward()
    assert calls == {"fused_map_stats": 2}
    calls.clear()
    with torch.inference_mode():
        net.eval()(x)
    want = ({"fused_attention_block_stats": 2,
             "fused_attention_mean_padded": 1} if dtype == torch.bfloat16
            else {"fused_attention_mean_padded": 3, "fused_map_stats": 2})
    assert calls == want


def test_train_mode_masked_forward_thresh_matches_jax(weights):
    """``masked_forward_thresh`` in training mode (JAX's
    ``deterministic=False``): the headloop's maps, normalized by the
    block, give JAX's rollout; x and cls_token_attn as in the eval
    contract (1e-4, 1e-5)."""
    params, x, _ = weights
    token_attn = np.random.default_rng(5).uniform(
        0, 2.0 / 16, size=(4, 16)).astype(np.float32)
    want_x, want_attn = jax.jit(lambda p, im, ta: j_construct(DEIT, PP).apply(
        {"params": p}, im,
        method=lambda m, im: m.features.masked_forward_thresh(
            *m.features.embed_all(im, False), ta, [(2, 9)],
            deterministic=False),
    ))(params["deit"], jnp.asarray(x), jnp.asarray(token_attn))
    backbone = _port("deit", params["deit"]).features.train()
    got_x, got_attn = backbone.masked_forward_thresh(
        *backbone.embed_all(torch.from_numpy(x)),
        torch.from_numpy(token_attn), [(2, 9)],
    )
    np.testing.assert_allclose(to_np(got_attn), to_np(want_attn), atol=1e-5)
    np.testing.assert_allclose(to_np(got_x.detach()), to_np(want_x),
                               atol=1e-4)


def test_eval_forward_refuses_to_record_gradients(weights):
    """The kernels have no backward: an eval-mode forward with gradients
    on raises instead of returning a graph cut at the kernels."""
    params, x, _ = weights
    model = _port("deit", params["deit"])
    with pytest.raises(RuntimeError, match="no backward"):
        model(torch.from_numpy(x))


# --- DropPath and dropout ----------------------------------------------------

def test_drop_path_masks_whole_samples_and_scales_by_one_over_keep():
    dp = t_layers.DropPath(0.25).train()
    x = torch.ones((256, 5, 3))
    y = dp(x, torch.Generator().manual_seed(0))
    per_sample = y.reshape(256, -1)
    assert (per_sample == per_sample[:, :1]).all()
    assert set(per_sample[:, 0].tolist()) == {0.0, float(x[0, 0, 0] / 0.75)}
    assert 0.6 < float((per_sample[:, 0] > 0).float().mean()) < 0.9
    assert torch.equal(dp.eval()(x, torch.Generator().manual_seed(0)), x)


def _train_setup(params, drop_path_rate=0.0, opt=OPT):
    model = _port("deit", params["deit"], drop_path_rate=drop_path_rate)
    popt = _port_optim(opt)
    tx = t_train.make_optimizer(popt, model, steps_per_epoch=4)
    state = t_train.create_train_state(model, tx, with_ema=True, device="cpu")
    return state, t_train.make_train_step(model, PP, popt, device="cpu")


def _batch(x, labels):
    return {"image": 1.0 / (1.0 + np.exp(-x)), "label": labels}


def test_drop_path_draws_from_the_step_generator(weights):
    """drop_path_rate 0.1: one generator seed gives the same step twice,
    another seed another loss."""
    params, x, labels = weights
    batch = _batch(x, labels)
    results = []
    for seed in (5, 5, 6):
        state, step = _train_setup(params, drop_path_rate=0.1)
        gen = torch.Generator().manual_seed(seed)
        state, metrics = step(state, batch, gen, 1.0)
        results.append((float(metrics["loss"]),
                        state.model.prototype_vectors.detach().clone()))
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])
    assert results[0][0] != results[2][0]


# --- the train step ----------------------------------------------------------

def test_ppc_gate_zero_vs_one(weights):
    params, x, labels = weights
    out = []
    for gate in (0.0, 1.0):
        state, step = _train_setup(params)
        _, m = step(state, _batch(x, labels), torch.Generator(), gate)
        out.append({k: float(v) for k, v in m.items()})
    assert out[0]["ce_loss"] == out[1]["ce_loss"]
    assert out[0]["loss"] == out[0]["ce_loss"]
    np.testing.assert_allclose(
        out[1]["loss"],
        out[1]["ce_loss"] + out[1]["ppc_cov_loss"] + out[1]["ppc_mean_loss"],
        rtol=1e-6)
    assert out[1]["loss"] > out[0]["loss"]


def test_mixup_is_not_ported_yet():
    """Mixup is ported now (tests/test_torch_data.py holds the step against
    JAX): the step takes a ``MixupCutmix`` and refuses anything else."""
    from protopformer_tpu_torch.data import MixupCutmix

    with pytest.raises(TypeError, match="MixupCutmix"):
        t_train.make_train_step(None, PP, _port_optim(OPT), mixup=object(),
                                device="cpu")
    assert callable(t_train.make_train_step(
        None, PP, _port_optim(OPT), mixup=MixupCutmix(num_classes=4),
        device="cpu"))


# --- optimizer, EMA and schedules --------------------------------------------

def _grads(params, seed, frozen_scale=1.0):
    """Seeded gradients in the JAX params tree."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(params)
    grads = jax.tree.unflatten(treedef, [
        rng.normal(size=np.shape(a)).astype(np.float32) for a in leaves])
    for head in ("last_layer_w", "last_layer_global_w"):
        grads[head] = grads[head] * frozen_scale
    return grads


def _port_steps(params, cfg, grads_seq):
    model = _port("deit", params)
    tx = t_train.make_optimizer(_port_optim(cfg), model, steps_per_epoch=1)
    state = t_train.create_train_state(model, tx, with_ema=True, device="cpu")
    trained = dict(model.named_parameters())
    for grads in grads_seq:
        for name, g in _state_dict(grads, DEIT).items():
            if name not in FROZEN:
                trained[name].grad = g.clone()
        state.apply_gradients(cfg.model_ema_decay)
    return state


def _assert_state_close(port_module, jax_tree, atol=1e-6):
    want = _state_dict(jax.tree.map(np.asarray, jax_tree), DEIT)
    for name, p in port_module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("opt", ["adamw", "adam", "nesterov"])
def test_optimizer_steps_and_ema_match_optax(weights, opt):
    """Two steps over the three groups (LR 1e-4 then 5.5e-4: warm-up at one
    step an epoch), the EMA after each; frozen heads unchanged."""
    params = weights[0]["deit"]
    cfg = dataclasses.replace(OPT, opt=opt)
    grads_seq = [_grads(params, 1), _grads(params, 2)]
    j_state = j_create_state(jax.tree.map(jnp.asarray, params),
                             j_make_optimizer(cfg, params, 1), with_ema=True)
    port = _port_steps(params, cfg, grads_seq)
    apply = jax.jit(lambda s, g: s.apply_gradients(g, cfg.model_ema_decay))
    for grads in grads_seq:
        j_state = apply(j_state, grads)
    assert port.step == 2
    _assert_state_close(port.model, j_state.params)
    _assert_state_close(port.ema, j_state.ema_params)
    assert torch.equal(port.model.last_layer.weight,
                       torch.from_numpy(np.array(params["last_layer_w"]).T))


def test_clip_norm_counts_the_trainable_gradients_only(weights):
    """The port clips as the reference does, over the gradients of the
    trainable groups: optax's ``clip_by_global_norm`` over that subtree.
    The JAX package also counts the frozen heads' gradients (it clips
    before its group split), and so takes another step (ROADMAP F8)."""
    params = weights[0]["deit"]
    cfg = dataclasses.replace(OPT, opt="nesterov", clip_grad=1.0,
                              features_lr=0.1, warmup_lr=0.1, warmup_epochs=0)
    grads_seq = [_grads(params, 1, 30.0), _grads(params, 2, 30.0)]
    port = _port_steps(params, cfg, grads_seq)

    trainable = [k for k in params if k not in ("last_layer_w",
                                                "last_layer_global_w")]
    clip = optax.clip_by_global_norm(cfg.clip_grad)
    unclipped = dataclasses.replace(cfg, clip_grad=None)
    ref = j_create_state(jax.tree.map(jnp.asarray, params),
                         j_make_optimizer(unclipped, params, 1), False)
    jax_pkg = j_create_state(jax.tree.map(jnp.asarray, params),
                             j_make_optimizer(cfg, params, 1), False)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for grads in grads_seq:
        sub, _ = clip.update({k: grads[k] for k in trainable},
                             clip.init(None))
        ref = apply(ref, {**grads, **sub})
        jax_pkg = apply(jax_pkg, grads)
    _assert_state_close(port.model, ref.params)
    moved = np.abs(np.asarray(jax_pkg.params["prototype_vectors"])
                   - np.asarray(ref.params["prototype_vectors"])).max()
    assert moved > 1e-4


def test_param_groups_leave_the_frozen_tensors_out():
    from protopformer_tpu_torch.models import construct_ppnet

    model = construct_ppnet(*port_configs(DEIT, PP))
    tx = t_train.make_optimizer(_port_optim(OPT), model, 4)
    groups = {g["name"]: g for g in tx.optimizer.param_groups}
    assert {n: g["weight_decay"] for n, g in groups.items()} == {
        "features": 1e-3, "add_on": 1e-3, "prototypes": 0.05}
    named = {id(p): n for n, p in model.named_parameters()}
    in_groups = {named[id(p)] for g in groups.values() for p in g["params"]}
    assert in_groups == set(named.values()) - set(FROZEN)
    assert {named[id(p)] for p in groups["prototypes"]["params"]} == {
        "prototype_vectors", "prototype_vectors_global"}
    assert all(t_train.param_group_label(n) == "add_on"
               for n in map(named.get, map(id, groups["add_on"]["params"])))


@pytest.mark.parametrize("overrides", [
    {},
    {"lr_noise": (0.5, 0.8), "noise_seed": 1028},
    {"lr_noise": (0.3,)},
    {"lr_cycle_limit": 2, "warmup_epochs": 0},
    {"sched": "step", "decay_epochs": 3},
], ids=["cosine", "noise-window", "noise-from", "cycle-limit", "step"])
def test_group_schedules_match_jax(overrides):
    from protopformer_tpu.train.scheduler import make_group_schedules as j_mgs

    cfg = dataclasses.replace(OPT, epochs=20, cooldown_epochs=4, **overrides)
    spe = 3
    steps = np.arange(0, 50 * spe, spe)
    want = {k: np.asarray(jax.vmap(fn)(jnp.asarray(steps)))
            for k, fn in j_mgs(cfg, spe).items()}
    got = t_train.make_group_schedules(_port_optim(cfg), spe)
    assert set(got) == set(want)
    for name, fn in got.items():
        np.testing.assert_allclose([fn(s) for s in steps], want[name],
                                   rtol=2e-6, err_msg=name)
        assert fn(steps[4] + spe - 1) == fn(steps[4])  # staircase


def test_metric_logger_matches_jax():
    from protopformer_tpu.utils.metrics import MetricLogger as JaxLogger
    from protopformer_tpu_torch.utils import MetricLogger

    got, want = MetricLogger(), JaxLogger()
    for i in range(30):
        for logger in (got, want):
            logger.update(loss=1.0 / (i + 1), acc=float(i % 7))
    assert got.averages() == want.averages()
    assert str(got) == str(want)


# --- the loop ----------------------------------------------------------------

class _Loader:
    """Batches of a fixed image set, reshuffled per epoch; with ``pad``
    the last batch is padded to full size and carries a valid mask."""

    def __init__(self, images, labels, batch_size, pad=False):
        self.images, self.labels = images, labels
        self.batch_size, self.pad, self.epoch = batch_size, pad, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        n = len(self.labels)
        return -(-n // self.batch_size) if self.pad else n // self.batch_size

    def __iter__(self):
        n, bs = len(self.labels), self.batch_size
        order = (np.arange(n) if self.pad
                 else np.random.default_rng(self.epoch).permutation(n))
        for i in range(len(self)):
            idx = order[i * bs:(i + 1) * bs]
            valid = np.ones(bs, np.float32)
            valid[len(idx):] = 0.0
            idx = np.concatenate([idx, np.zeros(bs - len(idx), idx.dtype)])
            yield {"image": self.images[idx], "label": self.labels[idx],
                   "valid": valid}


def _cfg():
    return t_config.ExperimentConfig(
        backbone=port_configs(DEIT, PP)[0], ppnet=port_configs(DEIT, PP)[1],
        optim=_port_optim(OPT))


def test_smoke_train_overfits_synthetic():
    """The port of tests/test_train.py's smoke train: a micro PPNet with
    drop path 0.1 overfits 32 synthetic images in 6 epochs through
    ``train_one_epoch`` and ``evaluate``."""
    from protopformer_tpu.data import build_dataset_index
    from protopformer_tpu_torch.models import construct_ppnet

    index = build_dataset_index("synthetic", "", train=True, num_samples=32,
                                num_classes=4, image_size=32)
    loader = _Loader(index.images.astype(np.float32) / 255.0, index.labels, 16)
    bk, pp = port_configs(dataclasses.replace(DEIT, drop_path_rate=0.1), PP)
    model = construct_ppnet(bk, pp, generator=torch.Generator().manual_seed(0))
    popt = _port_optim(OPT)
    state = t_train.create_train_state(
        model, t_train.make_optimizer(popt, model, len(loader)), device="cpu")
    step = t_train.make_train_step(model, pp, popt, device="cpu")
    gen, cfg, losses, it = torch.Generator().manual_seed(0), _cfg(), [], 0
    for epoch in range(6):
        state, stats, it = t_train.train_one_epoch(
            step, state, loader, epoch, gen, cfg, global_iter=it,
            sync_every=3)
        losses.append(stats["loss"])
    assert it == 12 and state.step == 12
    assert losses[-1] < losses[0], losses
    loader.pad = True
    result = t_train.evaluate(t_train.make_eval_step(device="cpu"),
                              state.model, loader)
    assert result["acc1"] > 50.0, result


def test_train_one_epoch_fetches_in_windows_and_aborts_on_nonfinite():
    """A non-finite loss raises at the next window's fetch, at most
    ``sync_every - 1`` steps late; a clean epoch fetches its tail."""
    x = np.zeros((80, 2, 2, 3), np.float32)
    loader = _Loader(x, np.zeros(80, np.int64), 2)
    calls = []

    def bad_step(state, batch, gen, gate):
        calls.append(gate)
        loss = torch.tensor(math.nan if len(calls) == 8 else 1.0)
        return state, {"loss": loss, "ce_loss": loss}

    with pytest.raises(t_train.NonFiniteLossError, match="iter 7"):
        t_train.train_one_epoch(bad_step, None, loader, 0, None, _cfg(),
                                sync_every=5)
    assert 8 <= len(calls) <= 12
    assert set(calls) == {0.0}  # epoch 0 < ppc_start_epoch

    calls.clear()
    _, stats, it = t_train.train_one_epoch(
        lambda s, b, g, gate: (calls.append(gate), (s, {
            "loss": torch.tensor(2.0)}))[1],
        None, _Loader(x[:26], np.zeros(26, np.int64), 2), 20, None, _cfg(),
        sync_every=5)
    assert it == 13 and len(calls) == 13 and stats["loss"] == 2.0
    assert set(calls) == {1.0}  # the PPC gate opens at ppc_start_epoch


def test_evaluate_ragged_last_batch_matches_jax(weights):
    """``make_eval_step`` + ``evaluate`` over 11 images in batches of 4
    (the last padded and masked) against the JAX package's."""
    from protopformer_tpu.train import make_eval_step as j_make_eval_step
    from protopformer_tpu.train.loop import evaluate as j_evaluate

    params, _, _ = weights
    rng = np.random.default_rng(8)
    images = rng.uniform(size=(11, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 11)
    loader = _Loader(images, labels, 4, pad=True)
    want = j_evaluate(j_make_eval_step(j_construct(DEIT, PP), True),
                      params["deit"], list(loader))
    got = t_train.evaluate(t_train.make_eval_step(device="cpu"),
                           _port("deit", params["deit"]), loader)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
