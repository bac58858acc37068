"""The port's checkpoint layer against the JAX package's: the epoch manager
(round trip, retention, resume), the reference-layout ``.pth`` ingest and
export, the pretrained resolver, and the backbones' timm layout.

Tolerances: every comparison is exact but two. ``resize_pos_embed`` is
held within 1e-5 of ``jax.image.resize``'s bicubic (two libraries'
float32 sums, measured ~1e-6); the reference PyTorch PPNet driven by the
port's export within 1e-4 in its logits (the JAX package's own export
contract, ``tests/test_export.py``).
"""

import dataclasses
import hashlib
import os
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from protopformer_tpu.checkpoint import pretrained as j_pretrained
from protopformer_tpu.checkpoint import torch_convert as j_convert
from protopformer_tpu.core.config import BackboneConfig, OptimConfig, PPNetConfig
from protopformer_tpu_torch import train as t_train
from protopformer_tpu_torch.checkpoint import (
    PRETRAINED_URLS,
    CheckpointManager,
    basenet_state_dict_from_jax,
    cached_path,
    deit_state_dict_from_jax,
    export_ppnet_state_dict,
    load_params,
    load_pretrained_backbone,
    load_torch_checkpoint,
    resize_pos_embed,
    resolve_pretrained,
    save_params,
    save_torch_checkpoint,
)
from protopformer_tpu_torch.checkpoint.manager import manager_for
from protopformer_tpu_torch.core import config as t_config
from protopformer_tpu_torch.models import construct_ppnet, create_backbone
from tests.manifests import ALL_MANIFESTS
from tests.oracle_deit import RefDeiT, RefPPNet
from tests.torch_port import jax_params, port_configs, port_model

BK = BackboneConfig(
    name="tiny-test", arch="deit", img_size=32, patch_size=8,
    embed_dim=24, depth=3, num_heads=2, drop_path_rate=0.1,
    rollout_discard_ratio=0.7,
)
PP = PPNetConfig(
    prototype_shape=(40, 16, 1, 1), num_classes=4,
    reserve_layers=(2,), reserve_token_nums=(9,),
    use_global=True, global_proto_per_class=3,
)
OPT = t_config.OptimConfig(epochs=4, warmup_epochs=1, warmup_lr=1e-4,
                           features_lr=1e-3, model_ema_decay=0.9)


# --- the epoch manager ------------------------------------------------------

class _Loader:
    """Seeded [0, 1] images in shuffled batches of 8, reshuffled per epoch
    as ``HostDataLoader`` is."""

    def __init__(self, n=32, seed=5):
        rng = np.random.default_rng(seed)
        self.images = rng.uniform(size=(n, 32, 32, 3)).astype(np.float32)
        self.labels = (np.arange(n) % 4).astype(np.int64)
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.labels) // 8

    def __iter__(self):
        order = np.random.default_rng((3, self.epoch)).permutation(
            len(self.labels))
        for b in range(len(self)):
            ids = order[b * 8:(b + 1) * 8]
            yield {"image": self.images[ids], "label": self.labels[ids]}


def _state(seed=0):
    bk, pp = port_configs(BK, PP)
    model = construct_ppnet(bk, pp,
                            generator=torch.Generator().manual_seed(seed))
    tx = t_train.make_optimizer(OPT, model, steps_per_epoch=4)
    return t_train.create_train_state(model, tx, device="cpu")


def _cfg():
    bk, pp = port_configs(BK, PP)
    return t_config.ExperimentConfig(backbone=bk, ppnet=pp, optim=OPT)


def _epoch(state, loader, epoch, gen):
    step = t_train.make_train_step(state.model, state.model.config, OPT,
                                   device="cpu")
    state, _, _ = t_train.train_one_epoch(step, state, loader, epoch, gen,
                                          _cfg())
    return state


def _assert_states_equal(a, b):
    for x, y in ((a.model, b.model), (a.ema, b.ema)):
        sa, sb = x.state_dict(), y.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    oa = a.optimizer.optimizer.state_dict()
    ob = b.optimizer.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step


def test_manager_round_trip_is_bit_equal(tmp_path):
    """Model, EMA, optimizer, step, epoch, generator state and the meta
    come back bit for bit into a differently seeded state."""
    loader, gen = _Loader(), torch.Generator().manual_seed(7)
    state = _epoch(_state(), loader, 0, gen)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    path = mgr.save(0, state, {"val_acc1": 12.5, "best": True},
                    generator=gen, args={"seed": 1028, "shape": [40, 16]})
    assert path.endswith("checkpoint-0.pth") and mgr.latest_epoch() == 0

    gen2 = torch.Generator().manual_seed(99)
    restored, meta = mgr.restore(_state(seed=3), generator=gen2)
    _assert_states_equal(state, restored)
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert meta == {"epoch": 0, "step": 4, "val_acc1": 12.5, "best": True,
                    "args": {"seed": 1028, "shape": [40, 16]}}
    assert manager_for(path)[1] == 0 and manager_for(mgr.directory)[1] is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state())


def test_files_load_with_weights_only_and_hold_the_reference_keys(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(3, state, {"val_acc1": 1.0, "best": False},
                    generator=torch.Generator().manual_seed(0),
                    args={"resume": ""})
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"model", "model_ema", "optimizer",
                            "lr_scheduler", "epoch", "args", "step",
                            "generator", "val_acc1", "best"}
    assert payload["lr_scheduler"] == {"step": 0} and payload["epoch"] == 3
    assert payload["model"].keys() == state.model.state_dict().keys()


def test_max_to_keep_keeps_the_latest_three_as_the_jax_manager(tmp_path):
    """Orbax's retention as the JAX package sets it: the 3 most recent
    epochs; the best epoch (0 here) is not protected."""
    from protopformer_tpu.checkpoint.manager import CheckpointManager as JMgr
    from protopformer_tpu.train import create_train_state, make_optimizer

    state = _state()
    mgr = CheckpointManager(str(tmp_path / "port"))
    params = {"w": jnp.zeros((2,))}
    j_state = create_train_state(
        params, make_optimizer(OptimConfig(), params, 1), with_ema=False)
    j_mgr = JMgr(str(tmp_path / "jax"))
    for epoch in range(5):
        meta = {"val_acc1": 10.0 - epoch, "best": epoch == 0}
        mgr.save(epoch, state, meta)
        j_mgr.save(epoch, j_state, meta)
    assert mgr.epochs() == [2, 3, 4]
    kept = sorted(int(d) for d in os.listdir(tmp_path / "jax") if d.isdigit())
    assert kept == mgr.epochs()


def test_resume_reproduces_continuous_training_bit_for_bit(tmp_path):
    """Trap (b): with drop path 0.1 the step draws from the generator, so
    1 epoch + save + resume + 1 epoch equals 2 continuous epochs only when
    the checkpoint carries the generator's state."""
    loader = _Loader()
    gen = torch.Generator().manual_seed(11)
    continuous = _epoch(_epoch(_state(), loader, 0, gen), loader, 1, gen)

    gen = torch.Generator().manual_seed(11)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _epoch(_state(), loader, 0, gen), generator=gen)
    fresh_gen = torch.Generator().manual_seed(11)
    resumed, meta = mgr.restore(_state(seed=4), generator=fresh_gen)
    resumed = _epoch(resumed, loader, meta["epoch"] + 1, fresh_gen)
    _assert_states_equal(continuous, resumed)

    # the same resume without the generator's state draws other masks
    unseeded, _ = mgr.restore(_state(seed=4))
    unseeded = _epoch(unseeded, loader, 1, torch.Generator().manual_seed(11))
    assert not torch.equal(unseeded.model.prototype_vectors,
                           continuous.model.prototype_vectors)


def test_save_and_load_params_round_trip(tmp_path):
    state = _state()
    save_params(str(tmp_path / "w.pth"), state.model)
    other = load_params(str(tmp_path / "w.pth"), _state(seed=1).model)
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # a manager's root loads its latest epoch's model
    CheckpointManager(str(tmp_path / "ckpt")).save(0, state)
    other = load_params(str(tmp_path / "ckpt"), _state(seed=2).model)
    assert torch.equal(other.prototype_vectors, state.model.prototype_vectors)


# --- pos-embed resize (trap a) ---------------------------------------------

@pytest.mark.parametrize("g_old,g_new,prefix", [
    (14, 24, 1), (14, 28, 1), (24, 14, 1), (14, 32, 1), (14, 24, 2),
    (24, 14, 2), (4, 6, 1),
])
def test_resize_pos_embed_matches_jax(g_old, g_new, prefix):
    """Keys' a = -0.5 with antialiasing when shrinking: plain bicubic
    ``F.interpolate`` (a = -0.75) is 0.29 (growing) to 2.3 (shrinking)
    away on this input."""
    pe = np.random.default_rng(g_old * 100 + g_new).normal(
        size=(1, prefix + g_old * g_old, 8)).astype(np.float32)
    want = j_convert.resize_pos_embed(pe, g_new * g_new, prefix)
    got = resize_pos_embed(torch.from_numpy(pe), g_new * g_new, prefix)
    assert got.shape == want.shape == (1, prefix + g_new * g_new, 8)
    np.testing.assert_array_equal(got[:, :prefix].numpy(), pe[:, :prefix])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_resize_pos_embed_keeps_an_equal_grid():
    pe = torch.randn(1, 17, 8)
    assert resize_pos_embed(pe, 16) is pe


# --- .pth ingest ------------------------------------------------------------

def _timm_state_dict(cfg, seed, heads=True):
    """Seeded weights in the timm layout of ``cfg`` (+ 1000-class heads)."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g)
          for k, v in create_backbone(cfg).state_dict().items()}
    if heads:
        sd["head.weight"] = torch.randn(1000, cfg.embed_dim, generator=g)
        sd["head.bias"] = torch.randn(1000, generator=g)
    return sd


def _fb_file(tmp_path, sd, wrap):
    path = str(tmp_path / f"{wrap}.pth")
    if wrap == "fb":
        torch.save({"model": sd, "epoch": 300, "args": {"note": "junk"}},
                   path)
    else:
        torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("wrap", ["fb", "module"])
def test_load_torch_checkpoint_matches_jax(tmp_path, wrap):
    cfg = port_configs(BK, PP)[0]
    path = _fb_file(tmp_path, _timm_state_dict(cfg, 0), wrap)
    want = j_convert.load_torch_checkpoint(path)
    got = load_torch_checkpoint(path)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("arch,wrap,file_img", [
    ("deit", "fb", 32), ("deit", "module", 48), ("cait", "fb", 32)])
def test_load_pretrained_backbone_matches_jax(tmp_path, arch, wrap, file_img):
    """The JAX package's converted tree, taken to the port's layout by the
    port's converter, equals the port's loaded backbone: heads dropped, a
    48 px file's position embedding resized to the 32 px grid."""
    if arch == "deit":
        j_cfg = BK
    else:
        j_cfg = BackboneConfig(
            name="tiny-cait", arch="cait", img_size=32, patch_size=8,
            embed_dim=24, depth=3, num_heads=2, depth_token_only=2)
    t_cfg = port_configs(j_cfg, PP)[0]
    file_cfg = dataclasses.replace(t_cfg, img_size=file_img)
    path = _fb_file(tmp_path, _timm_state_dict(file_cfg, 1), wrap)

    tree = j_convert.load_pretrained_backbone(path, j_cfg)
    if arch == "deit":
        want = deit_state_dict_from_jax(tree, j_cfg.depth)
    else:
        lin = {"kernel": np.zeros((24, 2), np.float32),
               "bias": np.zeros(2, np.float32)}
        want = {k[len("features."):]: v for k, v in basenet_state_dict_from_jax(
            {"features": tree, "last_layer": lin}, "cait", j_cfg.depth,
            j_cfg.depth_token_only).items() if k.startswith("features.")}
    got = load_pretrained_backbone(path, t_cfg, device="cpu").state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-5 if k == "pos_embed" else 0,
                                   rtol=0, err_msg=k)
    assert got["pos_embed"].shape[1] == t_cfg.num_patches + (arch == "deit")


def test_load_pretrained_backbone_keeps_a_distilled_models_heads(tmp_path):
    cfg = dataclasses.replace(port_configs(BK, PP)[0], distilled=True)
    sd = _timm_state_dict(cfg, 2, heads=False)  # DistilledDeiT has both
    path = _fb_file(tmp_path, sd, "fb")
    got = load_pretrained_backbone(path, cfg, device="cpu").state_dict()
    assert got.keys() == sd.keys()
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


@pytest.mark.parametrize("name", sorted(ALL_MANIFESTS))
def test_backbone_state_dict_is_the_timm_layout(name):
    """Every registered architecture's backbone holds the timm checkpoint's
    keys and shapes, less the classifier head of a plain backbone (built on
    the meta device: nothing allocated)."""
    want = dict(ALL_MANIFESTS[name])
    if "distilled" not in name:
        want = {k: v for k, v in want.items() if not k.startswith("head.")}
    with torch.device("meta"):
        got = create_backbone(name).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == want


# --- the pretrained resolver ------------------------------------------------

def test_pretrained_table_equals_jax():
    assert PRETRAINED_URLS == j_pretrained.PRETRAINED_URLS


def _no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the resolver opened a socket")
    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


def test_resolver_file_url_copies_once_and_checks_the_hash(tmp_path,
                                                           monkeypatch):
    _no_network(monkeypatch)
    monkeypatch.setenv("PPF_CACHE_DIR", str(tmp_path / "cache"))
    data = b"weights" * 100
    digest = hashlib.sha256(data).hexdigest()[:8]
    src = tmp_path / f"deit-{digest}.pth"
    src.write_bytes(data)
    local = cached_path(f"file://{src}")
    assert local == str(tmp_path / "cache" / src.name)
    assert open(local, "rb").read() == data
    src.unlink()  # the second call reads the cache, not the source
    assert resolve_pretrained(f"file://{src}") == local

    bad = tmp_path / "deit-00000000.pth"
    bad.write_bytes(data)
    with pytest.raises(RuntimeError, match="hash mismatch"):
        cached_path(f"file://{bad}")
    assert not (tmp_path / "cache" / bad.name).exists()


def test_resolver_never_fetches(tmp_path, monkeypatch):
    """An http(s) URL or registered name resolves only from the cache; the
    error names the URL and the path to put the file at."""
    _no_network(monkeypatch)
    monkeypatch.setenv("PPF_CACHE_DIR", str(tmp_path))
    url = PRETRAINED_URLS["deit_tiny_patch16_224"]
    with pytest.raises(FileNotFoundError) as err:
        resolve_pretrained("deit_tiny_patch16_224")
    assert url in str(err.value)
    assert str(tmp_path / os.path.basename(url)) in str(err.value)
    with pytest.raises(FileNotFoundError, match="example.org"):
        resolve_pretrained("https://example.org/x.pth")
    (tmp_path / os.path.basename(url)).write_bytes(b"x")
    assert resolve_pretrained("deit_tiny_patch16_224") == str(
        tmp_path / os.path.basename(url))
    local = tmp_path / "local.pth"
    local.write_bytes(b"x")
    assert resolve_pretrained(str(local)) == str(local)
    with pytest.raises(FileNotFoundError, match="registered"):
        resolve_pretrained("no_such_arch")


# --- export -----------------------------------------------------------------

@pytest.mark.parametrize("use_global", [True, False])
def test_export_equals_jax_export(use_global):
    pp = dataclasses.replace(PP, use_global=use_global)
    params = jax_params(BK, pp, seed=3)
    want = j_convert.export_ppnet_state_dict(params, "deit", BK.depth)
    got = export_ppnet_state_dict(port_model(BK, pp, params))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_exported_file_drives_the_reference_ppnet(tmp_path):
    """The port's export of a port model, saved and loaded STRICTLY into
    the reference-layout torch PPNet, reproduces the port's logits."""
    model = construct_ppnet(*port_configs(BK, PP),
                            generator=torch.Generator().manual_seed(6))
    path = str(tmp_path / "export.pth")
    save_torch_checkpoint(path, export_ppnet_state_dict(model))
    ref = RefPPNet(
        RefDeiT(img_size=32, patch_size=8, dim=24, depth=3, heads=2),
        num_prototypes=40, proto_dim=16, num_classes=4,
        reserve_layer_nums=[(2, 9)], global_per_class=3, discard_ratio=0.7,
    )
    ref.load_state_dict(
        torch.load(path, map_location="cpu", weights_only=True)["model"],
        strict=True)
    ref.eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        out = model(x)
        logits, cls_attn, *_ = ref(x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.logits.numpy(), logits.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.cls_token_attn.numpy(), cls_attn.numpy(),
                               atol=1e-5)
