"""The operation and byte counts against published figures."""

import pytest

from benchmark import counts, harness


def cfg(name):
    return harness.model_cfg(
        harness.read_json(harness.BENCH / "configs" / f"{name}.json"),
        "serve")


@pytest.mark.parametrize("name, gmac", [("deit_tiny224_cub", 1.3),
                                        ("deit_b384_cub", 55.5)])
def test_unpruned_backbone_matches_published_compute(name, gmac):
    """DeiT's published multiply-adds an image (Touvron et al., Table 1
    and the 384 px row): within 4 %."""
    macs = counts.backbone_flops(cfg(name), pruned=False) / 2
    assert macs == pytest.approx(gmac * 1e9, rel=0.04)


def test_pruned_forward_is_below_the_unpruned_one():
    for name in ("deit_tiny224_cub", "deit_b384_cub"):
        c = cfg(name)
        assert counts.forward_flops(c) < counts.backbone_flops(c, False)
        assert counts.train_flops(c) == 3 * counts.forward_flops(c)
    b384 = counts.forward_flops(cfg("deit_b384_cub"))
    assert b384 == pytest.approx(103e9, rel=0.05)


@pytest.mark.parametrize("n, c, mb", [(197, 192, 60.96), (577, 768, 674.1)])
def test_k1_contract_bytes(n, c, mb):
    """K1's contract bytes at B=160 in speed mode: qkv, out, the bf16 map,
    t and s. (PERF.md's kernel table reads 60.8 MB at 197 tokens beside a
    0.0182 ms bound, which is 60.96 MB at 3.35 TB/s.)"""
    assert counts.k1_bytes(160, n, c) == pytest.approx(mb * 1e6, rel=1e-3)
    assert counts.k1_bound_s(160, n, c) == pytest.approx(
        mb * 1e6 / counts.HBM_BYTES_PER_S, rel=1e-3)
