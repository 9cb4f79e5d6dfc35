"""The int8 GEMM kernels' dispatch (``autotune.cim_matmul_config``: path,
tile and split of K1 ``cim_matmul`` and K4 ``bitplane_matmul`` on the
card), checked on the CPU from shapes alone, and the K1 wrapper's CPU path
against the JAX reference at the decode-bucket edge M values the card's
tiles split on.  The kernels themselves are held against their plain
twins on the card (test_torch_kernels_gpu.py and chip_smoke.py)."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.cim_matmul import ref as jref
from repro_torch import convert
from repro_torch.kernels import autotune
from repro_torch.kernels.cim_matmul import ops as cim_ops

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
H100_SMS = 132

# (K, N) of qwen3-8b's linears: q/o, k/v, gate/up, down, head.
SERVING_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096),
              (4096, 152064))
SERVING_M = (1, 3, 7, 8, 9, 16, 17, 64, 128, 509, 512)
# (M, K, N) of VGG-8's eight layers at batch 32 and 64.
VGG8_MKN = tuple((b * p, k, n) for b in (32, 64) for p, k, n in (
    (1024, 27, 128), (1024, 1152, 128), (256, 1152, 256), (256, 2304, 256),
    (64, 2304, 512), (64, 4608, 512), (1, 8192, 1024), (1, 1024, 10)))


def _all_shapes():
    return ([(m, k, n) for k, n in SERVING_KN for m in SERVING_M]
            + list(VGG8_MKN))


def _instantiated(source: str) -> set:
    """(nt, bt) pairs the C entry point of ``csrc/<source>.cu`` launches."""
    text = (CSRC / f"{source}.cu").read_text()
    return {(int(a), int(b)) for a, b in
            re.findall(r"nt == (\d+) && bt == (\d+)", text)}


def _blocks(cfg, m, n):
    return -(-n // (64 * cfg.nt)) * -(-m // cfg.bt) * cfg.splits


def _check_valid(cfg, m, k, n, sms):
    assert cfg.path in ("wgmma", "masked")
    if cfg.path == "masked":
        assert (k % 16 or n % 16) and cfg == ("masked", 0, 0, 1)
        return
    assert k % 16 == 0 and n % 16 == 0
    assert (cfg.nt, cfg.bt) in _instantiated("cim_matmul")
    assert (cfg.nt, cfg.bt) in _instantiated("bitplane_matmul")
    assert 1 <= cfg.splits <= autotune.GEMM_MAX_SPLITS
    assert cfg.splits & (cfg.splits - 1) == 0
    if m <= 16:                 # decode: one token tile, no 64-row padding
        assert m <= cfg.bt <= 16
    # The smallest split count that makes a wave (or the most there is).
    if cfg.splits > 1:
        assert _blocks(cfg._replace(splits=cfg.splits // 2), m, n) < sms


@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_every_path_shape_gets_a_valid_config(sms):
    """Every serving (K, N) at every decode/prefill M, and every VGG-8
    layer, gets a path the C entry points launch, with a valid tile and
    split."""
    for m, k, n in _all_shapes():
        _check_valid(autotune.cim_matmul_config(m, n, k, sms), m, k, n, sms)


@pytest.mark.parametrize("m,k,n", [
    (32768, 27, 128),       # VGG-8 conv1: 27-byte activation rows
    (32, 1024, 10),         # VGG-8 head: 10-byte weight rows
    (9, 100, 36), (3, 13, 7), (8, 4104, 1024), (8, 4096, 1000)])
def test_strides_copies_cannot_describe_take_the_masked_path(m, k, n):
    """Rows whose byte length is not a multiple of 16 cannot be copied 16
    bytes at a time: the byte-masked kernel takes them."""
    assert autotune.cim_matmul_config(m, n, k, H100_SMS) == (
        "masked", 0, 0, 1)


@pytest.mark.parametrize("m", [1, 3, 8, 9, 16])
def test_decode_fills_the_card(m):
    """At decode every serving linear, k/v included (16 column tiles of
    64), gets at least one wave of blocks on a 132-SM card."""
    for k, n in SERVING_KN:
        cfg = autotune.cim_matmul_config(m, n, k, H100_SMS)
        assert cfg.path == "wgmma"
        assert _blocks(cfg, m, n) >= H100_SMS, (k, n, cfg)
    kv = autotune.cim_matmul_config(m, 1024, 4096, H100_SMS)
    assert kv.nt == 1 and kv.splits == 16


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16])
def test_no_split_or_block_without_work(sms):
    """Splits take ceil(steps / splits) K steps of 64 bytes each and the
    last gets at least one; every token and column tile holds at least
    one real row or column."""
    for m in (1, 3, 8, 9, 16, 17, 64, 65, 509, 512, 4096):
        for k in (16, 48, 64, 80, 1024, 1152, 4096, 12288):
            for n in (16, 64, 112, 128, 1024, 4096):
                cfg = autotune.cim_matmul_config(m, n, k, sms)
                _check_valid(cfg, m, k, n, sms)
                steps = -(-k // autotune.GEMM_BK)
                per = -(-steps // cfg.splits)
                assert (cfg.splits - 1) * per < steps, (m, k, n, cfg)
                tiles_m = -(-m // cfg.bt)
                tiles_n = -(-n // (64 * cfg.nt))
                assert (tiles_m - 1) * cfg.bt < m
                assert (tiles_n - 1) * 64 * cfg.nt < n


@pytest.mark.parametrize("m", [1, 3, 7, 9, 16, 17])
@pytest.mark.parametrize("requant", [False, True])
def test_cim_matmul_bucket_edge_m_bit_exact(m, requant):
    """The K1 wrapper's CPU path (its plain twin) equals the JAX reference
    at the M values where the card's token tile changes (8, 16, 64)."""
    rng = np.random.default_rng(100 + m)
    k, n = 64, 48
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random(n) * 1e-2).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    out_scale = 0.5 if requant else 1.0
    want = jref.cim_matmul_ref(
        jnp.asarray(a), jnp.asarray(w), jnp.float32(0.05), jnp.asarray(ws),
        jnp.asarray(bias), jnp.float32(out_scale), relu=True,
        requant=requant)
    got = cim_ops.cim_matmul(
        convert.tensor_from_numpy(a), convert.tensor_from_numpy(w), 0.05,
        convert.tensor_from_numpy(ws), convert.tensor_from_numpy(bias),
        out_scale if requant else None, relu=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (K, N) of every deployed linear of the model families at published
# widths: q, k/v, o, the MLP (gate/up, down) or the expert banks and the
# shared experts, an SSM block's in_proj and out_proj, and the head.
FAMILY_KN = {
    "deepseek-7b": ((4096, 4096), (4096, 11008), (11008, 4096),
                    (4096, 102400)),
    "stablelm-12b": ((5120, 5120), (5120, 1280), (5120, 13824),
                     (13824, 5120), (5120, 100352)),
    "h2o-danube-3-4b": ((3840, 3840), (3840, 960), (3840, 10240),
                        (10240, 3840), (3840, 32000)),
    "granite-moe-1b-a400m": ((1024, 1024), (1024, 512), (512, 1024),
                             (1024, 49408)),
    "moonshot-v1-16b-a3b": ((2048, 2048), (2048, 1408), (1408, 2048),
                            (2048, 2816), (2816, 2048), (2048, 163840)),
    # in_proj 2 x 4096 + 2 x 128 + 64 heads, out_proj; head 50432 (the
    # vocab 50280 padded to a multiple of 256).
    "mamba2-1.3b": ((2048, 8512), (4096, 2048), (2048, 50432)),
    # in_proj 2 x 5120 + 2 x 64 + 80 heads (N % 64 = 16), out_proj; the
    # shared attention block's q/k/v/o and MLP; head 32000.
    "zamba2-2.7b": ((2560, 10448), (5120, 2560), (2560, 2560),
                    (2560, 10240), (10240, 2560), (2560, 32000)),
    # q/k/v/o and the cross-attention's (MHA), the gelu MLP's in and out,
    # head 51968 (the vocab 51866 padded to a multiple of 256).
    "whisper-large-v3": ((1280, 1280), (1280, 5120), (5120, 1280),
                         (1280, 51968)),
    "qwen2-vl-72b": ((8192, 8192), (8192, 1024), (8192, 29568),
                     (29568, 8192), (8192, 152064)),
}
# M of the family's calls: decode rows, prompt lengths, and an expert
# bank's G*C rows (a dropless 64-token prompt; capacity 60 for moonshot
# and 160 for granite at a 512-token prompt); the state-space runs'
# prompts of 192, 1024 and 4096 tokens and their batch of 4 x 512;
# whisper's decoder prompts at batch 4 (16, 256) and its encoder's 1500
# frames at batch 1 and 4 (M not a multiple of any row tile); qwen2-vl's
# 288-token image prompt.
FAMILY_M = (1, 4, 8, 16, 60, 64, 160, 192, 200, 256, 288, 512, 1024, 1500,
            2048, 2560, 4096, 4608, 6000)


def _family_kn(cfg):
    """(K, N) of cfg's deployed linears, from its dimensions."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kn = {(d, cfg.padded_vocab)}
    if cfg.ssm is not None:
        di, n = cfg.ssm.d_inner(d), cfg.ssm.d_state
        kn |= {(d, 2 * di + 2 * n + cfg.ssm.n_heads(d)), (di, d)}
        if cfg.arch_type == "ssm":
            return kn
    kn |= {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d)}
    ff = cfg.moe.d_ff_expert if cfg.moe else cfg.d_ff
    kn |= {(d, ff), (ff, d)}
    if cfg.moe and cfg.moe.n_shared_experts:
        s = ff * cfg.moe.n_shared_experts
        kn |= {(d, s), (s, d)}
    return kn


@pytest.mark.parametrize("arch", sorted(FAMILY_KN))
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_family_shapes_get_a_valid_config(arch, sms):
    """Every deployed linear of the family models (from their configs)
    takes the wgmma path at every M of their calls, with a tile and split
    the C entry points launch."""
    from repro_torch import configs
    kn = _family_kn(configs.get_config(arch))
    assert kn == set(FAMILY_KN[arch])
    for k, n in sorted(kn):
        for m in FAMILY_M:
            cfg = autotune.cim_matmul_config(m, n, k, sms)
            assert cfg.path == "wgmma", (arch, m, k, n)
            _check_valid(cfg, m, k, n, sms)


@pytest.mark.parametrize("k,n,act", [
    # The expert banks (moonshot, granite) take int8 codes.
    *(pytest.param(k, n, np.int8, id=f"{k}-{n}") for k, n in (
        (2048, 1408), (1408, 2048), (1024, 512), (512, 1024))),
    # The SSM projections (zamba2's in_proj, mamba2's in_proj and
    # out_proj), whisper's linears and head, and qwen2-vl's q/o and k/v
    # take f32 activations.  (qwen2-vl's MLP and head, 0.24-1.25 G
    # weights, are held on the card only: the float64 product here would
    # take 2-10 GB.)
    *(pytest.param(k, n, np.float32, id=f"{k}-{n}-f32") for k, n in (
        (2560, 10448), (2048, 8512), (4096, 2048), (1280, 1280),
        (1280, 5120), (5120, 1280), (1280, 51968), (8192, 8192),
        (8192, 1024)))])
@pytest.mark.parametrize("m", [1, 60])
def test_bank_shapes_bit_exact(k, n, act, m):
    """K1's CPU path equals the JAX reference at the expert-bank, SSM
    projection and multimodal (K, N), with the activations the serving
    path passes: the
    banks' int8 codes, or f32 that the wrapper quantises
    (``clip(rint(a / a_scale))``) where the reference takes the codes."""
    rng = np.random.default_rng(k + n + m)
    if act == np.int8:
        a = rng.integers(-128, 128, (m, k)).astype(np.int8)
        a_q = jnp.asarray(a)
    else:
        a = rng.standard_normal((m, k)).astype(np.float32) * 2.0
        a_q = jnp.clip(jnp.round(jnp.asarray(a) / jnp.float32(0.05)), -128,
                       127).astype(jnp.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random(n) * 1e-2).astype(np.float32)
    zero = np.zeros(n, np.float32)
    want = jref.cim_matmul_ref(
        a_q, jnp.asarray(w), jnp.float32(0.05), jnp.asarray(ws),
        jnp.asarray(zero), jnp.float32(1.0))
    got = cim_ops.cim_matmul(
        convert.tensor_from_numpy(a), convert.tensor_from_numpy(w), 0.05,
        convert.tensor_from_numpy(ws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
