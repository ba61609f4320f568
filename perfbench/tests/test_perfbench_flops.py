"""The yardstick's arithmetic against counts worked by hand."""

import pytest

from perfbench import spec
from perfbench.flops import attention, bert, mixtral


def test_mixtral_flops_per_token():
    c = spec.load("mixtral-2l.pretrain-s4096")
    # attention 4096 x 48 x 128 + 32 x 128 x 4096 = 41,943,040; routed
    # 2 x 3 x 4096 x 14336 + 4096 x 8 = 352,354,304; two layers and the
    # 4096 x 32000 head: 919,666,688 parameters a token, x 6, plus
    # 6 x 2 x 4096 x 4096 for causal attention.
    assert mixtral.flops_per_token(c.config, c.traffic) == (
        6 * 919_666_688 + 201_326_592)


def test_bert_flops_per_token():
    c = spec.load("bert-base.phase2-s512")
    # 109,483,776 parameters, 24,030,720 of them the head; per sequence
    # (6 x 85,453,056 + 12 x 12 x 768 x 512) x 512 + 6 x 24,030,720 x 76.
    per_seq = (6 * 85_453_056 + 56_623_104) * 512 + 6 * 24_030_720 * 76
    assert bert.flops_per_token(c.config, c.traffic) == pytest.approx(
        per_seq / 512, rel=1e-12)
    assert bert._params(c.config) == 109_483_776


def test_bert_flash_bound_is_bytes():
    c = spec.load("bert-base.phase2-s512")
    shape = bert.attention_shape(c.config, c.traffic)
    assert shape == dict(b=64, sq=512, sk=512, h=12, hkv=12, d=64,
                         causal=False)
    # q, k, v in and out written: 4 x 50,331,648 B, lse 1,572,864 B.
    assert attention.bound_s("fwd", shape) == pytest.approx(
        202_899_456 / 3.35e12)


def test_mixtral_flash_bound_is_operations():
    c = spec.load("mixtral-2l.pretrain-s4096")
    shape = mixtral.attention_shape(c.config, c.traffic)
    assert shape["b"] == 1 and shape["causal"]
    pairs = 4096 * 4097 // 2
    for kind, macs in (("fwd", 2), ("dq", 3), ("dkv", 4)):
        assert attention.bound_s(kind, shape) == pytest.approx(
            2 * macs * 128 * pairs * 32 / 989e12)


@pytest.mark.parametrize("name,kind", [
    ("void flash::fwd_kernel_tc<128, false>(...)", "fwd"),
    ("void flash::bwd_dq_kernel_tc<64, false>(...)", "dq"),
    ("void flash::bwd_dkv_kernel_tc<64, false>(...)", "dkv"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", None),
])
def test_kernel_kinds(name, kind):
    assert attention.kind(name) == kind
