"""Flash attention (causal or not, GQA): a hand-written Hopper kernel.

The counterpart of ``repro/kernels/flash_attention.py``: softmax attention
of ``q[B, H, Sq, d]`` over ``k, v[B, Hkv, Skv, d]``, query head ``h``
reading kv head ``h // (H // Hkv)``, with an online softmax whose running
maximum, denominator and accumulator are float32.  The causal mask is
top-left (``qpos >= kpos``, both counted from 0).  The wrapper keeps the
reference's tile arguments, clamps and refusals (``Sq % q_blk`` and
``Skv % kv_blk`` must be 0 after the clamps); the kernels take their own
tiles, and any ``d`` up to 128.  Three kernels, chosen by :func:`route`:

* ``"decode"`` - a kv group's query rows are few (``(H // Hkv) * Sq <=
  8``) and its rows 16-byte loads: ``csrc/flash_decode.cu`` cuts each
  kv group's keys into parts (:func:`decode_split`) and merges them in
  order, float32 arithmetic in both dtypes.  bfloat16: a thread-block
  cluster a kv group on the tensor cores, each warp loading its keys by
  TMA, the warps' partials and then the ranks' folded through
  distributed shared memory, in one launch with no scratch.  float32: the
  split-kv kernel, a warp a split on the CUDA cores, its partials in a
  float32 scratch merged by a second kernel.  Its plain version is
  :func:`flash_decode_plain`;
* ``"tc"`` - bfloat16 prefill whose tensors TMA can address:
  ``csrc/flash_attention_tc.cu``, FlashAttention-3's design on Hopper (a
  producer warpgroup keeping K and V tiles of ``TC_KV_TILE`` keys in
  flight by TMA, consumer warpgroups on wgmma) with p rounded to bfloat16
  for the product with v;
* ``"simt"`` - everything else (float32 prefill in full float32):
  ``csrc/flash_attention.cu`` on the CUDA cores, register outer products
  over :func:`simt_q_tile` queries (256 at d = 64, 128 at d <= 32, 64 at
  d = 128) and 64 keys a CTA.

The prefill kernels walk the kv axis in tiles of keys, ``KV_TILE`` on
the ``"simt"`` route and ``TC_KV_TILE`` on ``"tc"``, and
:func:`flash_attention_plain` is their plain version, walking the same
tiles.

``with_lse=True`` asks every route for each row's logsumexp as well,
float32 ``lse[B, H, Sq]``: the natural log of the softmax's denominator
over the scaled scores, ``m + log(max(l, 1e-30))`` as the reference's
``_flash_fwd_lse`` gives it (the prefill kernels keep ``m`` in log2 units
of pre-scaled scores and write ``m ln 2 + ln l``; so does the decode
kernel, from the row's folded ``m`` and ``l``).  The trainable
attention's backward reads it.  Without it the kernels take a null
pointer and run as before, bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import _native
from repro_torch.kernels.launcher import (F, I, P, Launcher, check_tensors,
                                          dtype_code)
from repro_torch.kernels.ref import NEG_INF

KERNEL = Launcher(symbol="launch_flash_attention",
                  argtypes=(P,) * 4 + (I,) * 7 + (F, I, P, P),
                  source="src/repro_torch/csrc/flash_attention.cu")
KERNEL_TC = Launcher(symbol="launch_flash_attention_tc",
                     argtypes=(P,) * 4 + (I,) * 7 + (F, I, P, P),
                     source="src/repro_torch/csrc/flash_attention_tc.cu")
KERNEL_DECODE = Launcher(symbol="launch_flash_decode",
                         argtypes=(P,) * 7 + (I,) * 7 + (F,) + (I,) * 4
                         + (P, P),
                         source="src/repro_torch/csrc/flash_decode.cu")
#: the "simt" prefill kernel's kv tile: the plain version walks the same
#: tiles
KV_TILE = 64
#: the "tc" prefill kernel's kv tile (its wgmma's N for q k^T).  The
#: wrapper passes it to the launcher, which refuses any other, and the
#: plain version walks the same tiles on that route
TC_KV_TILE = 128
#: the widest head the kernels' registers and shared memory are laid out for
MAX_D = 128
#: the most query rows of one kv group (heads times queries) that the
#: decode kernel holds in registers
DECODE_ROWS = 8
#: the decode kernel's warps a part of a kv group's keys, by dtype: a
#: tile of the part's keys is ``DECODE_WARPS[dtype] * decode_tile(dtype,
#: d)`` keys, warp w taking the w-th ``decode_tile``.  bfloat16: a cluster
#: rank's CTA of 4 warps; float32: one warp a split
DECODE_WARPS = {torch.bfloat16: 4, torch.float32: 1}
#: bfloat16: the most CTAs of the decode kernel's cluster, one kv group's
DECODE_CLUSTER = 8
#: bfloat16: the CTAs below which :func:`decode_split` doubles a group's
#: cluster, one an SM of an H100
DECODE_CTAS = 132
#: float32: the warps the split-kv kernel aims to run, one wave of an H100
#: (132 SMs of 4 blocks of 4 warps): its split of the kv axis is ``B *
#: Hkv * Skv / DECODE_SPLIT_WARPS`` keys, rounded up to whole 32s
DECODE_SPLIT_WARPS = 132 * 16
#: (rtol, atol) within which each route's kernel holds its plain version,
#: by route and dtype.  Kernel and plain version compute the same float32
#: values up to the order of their sums and round the output once, so in
#: bfloat16 they may land on neighbouring values: one ulp, at most 2^-7 of
#: the value (rtol 1e-2).  atol covers outputs near 0.  On the "tc" route
#: the kernel's p (exp2 of a pre-scaled score) and the plain version's
#: (exp) can round to neighbouring bfloat16 values, and such steps add up
#: where an output cancels to near 0: tools/flash_plain_err.py measured at
#: worst an atol of 1.1e-3 there (granite-3-2b's prefill, 3 seeds, on an
#: H100; the wgmma kernel on 128-key tiles as the mma.sync kernel on 64),
#: 1.7e-7 on the "simt" route, and on "decode" 1.7e-7 (the tensor cores'
#: p·v with p as bfloat16 hi + lo, NVIDIA H100 80GB HBM3 at 700 W); the
#: atols below keep room of 2.7x and more.  float32 keeps
#: tests/test_kernels.py's 2e-5.
PLAIN_TOL = {**{(r, torch.float32): (2e-5, 2e-5)
                for r in ("simt", "tc", "decode")},
             ("simt", torch.bfloat16): (1e-2, 1e-4),
             ("tc", torch.bfloat16): (1e-2, 3e-3),
             ("decode", torch.bfloat16): (1e-2, 1e-4)}


def simt_q_tile(d: int) -> int:
    """The query rows a CTA of the ``"simt"`` kernel owns at head width
    ``d``, as its launcher's ``flash_attention_q_tile`` gives them (builds
    the kernels' library at first use)."""
    return _native.function("flash_attention_q_tile", (I,))(d)


def simt_ctas(B: int, H: int, Sq: int, d: int) -> int:
    """The CTAs that the ``"simt"`` kernel's launcher starts for ``B * H``
    heads of ``Sq`` queries, as its ``flash_attention_ctas`` gives them."""
    return _native.function("flash_attention_ctas", (I,) * 4)(B, H, Sq, d)


def tc_q_tile(d: int) -> int:
    """The query rows a CTA of the ``"tc"`` kernel owns at head width
    ``d``, as its launcher's ``flash_attention_tc_q_tile`` gives them
    (builds the kernels' library at first use)."""
    return _native.function("flash_attention_tc_q_tile", (I,))(d)


def _padded(d: int) -> int:
    return 32 if d <= 32 else 64 if d <= 64 else 128


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes ``q`` over ``k`` and ``v``:

    * ``"decode"`` when a kv group has at most ``DECODE_ROWS`` query rows
      (``(H // Hkv) * Sq``), ``Skv > 0``, ``d * element size`` is a
      multiple of 16 and the tensors start on 16-byte boundaries -
      whatever the causal flag: under the top-left mask, row ``i`` sees
      keys ``0 .. i``;
    * ``"tc"`` for the other bfloat16 calls with ``d % 8 == 0`` and
      16-byte aligned tensors;
    * ``"simt"`` otherwise.

    A pure function of dtypes, shapes and alignment."""
    B, H, Sq, d = q.shape
    Hkv = k.shape[1]
    rows = (H // Hkv) * Sq if Hkv and H % Hkv == 0 else DECODE_ROWS + 1
    aligned = _aligned(q, k, v)
    if (rows <= DECODE_ROWS and k.shape[2] > 0
            and (d * q.element_size()) % 16 == 0 and aligned):
        return "decode"
    if q.dtype == torch.bfloat16 and d % 8 == 0 and aligned:
        return "tc"
    return "simt"


def decode_tile(dtype: torch.dtype, d: int) -> int:
    """Keys a warp of the decode kernel takes from each tile: in bfloat16
    16, one k16 step of the tensor cores' ``p @ v``; in float32 4 key rows
    a lane, ``DP * 4 / 16`` lanes a key row.  The wrapper passes it to the
    launcher, which refuses any other tile than its own."""
    if dtype == torch.bfloat16:
        return 16
    return 4 * 32 // (_padded(d) * 4 // 16)


def decode_split(B: int, Hkv: int, Skv: int, dtype: torch.dtype,
                 d: int) -> tuple[int, int]:
    """``(parts, per)``: the decode kernel's parts of a kv group's keys
    and the keys of each, ``parts = ceil(Skv / per)``, none empty.
    bfloat16: a cluster's ranks, ``per`` a whole number of tiles; the
    cluster doubles, up to ``DECODE_CLUSTER``, while the ``B * Hkv *
    parts`` CTAs stay below ``DECODE_CTAS`` and no rank would be left
    without keys.  float32: the split-kv kernel's splits of ``B * Hkv *
    Skv / DECODE_SPLIT_WARPS`` keys rounded up to whole 32s.  The same
    rule as the launcher's ``flash_decode_per`` (:func:`decode_per`),
    kept here for the plain version, which runs where no card is."""
    if dtype != torch.bfloat16:
        per = max(32, -(-B * Hkv * Skv // DECODE_SPLIT_WARPS))
        per = -(-per // 32) * 32
        return -(-Skv // per), per
    tile = DECODE_WARPS[dtype] * decode_tile(dtype, d)

    def per_rank(c):
        return -(-Skv // (c * tile)) * tile

    cluster = 1
    while (cluster < DECODE_CLUSTER and B * Hkv * cluster < DECODE_CTAS
           and (2 * cluster - 1) * per_rank(2 * cluster) < Skv):
        cluster *= 2
    return cluster, per_rank(cluster)


def decode_per(B: int, Hkv: int, Skv: int, dtype: torch.dtype,
               d: int) -> int:
    """The keys of each part of a kv group as the decode kernel's
    launcher's ``flash_decode_per`` gives them (builds the kernels'
    library at first use)."""
    return _native.function("flash_decode_per", (I,) * 5)(
        B, Hkv, Skv, d, int(dtype == torch.bfloat16))


def _check(q, k, v, q_blk, kv_blk) -> torch.device:
    dev = check_tensors("flash_attention", q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, H, Sq, d] and k, v "
                         f"[B, Hkv, Skv, d] expected; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v are {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, H, Sq, d = q.shape
    B2, Hkv, Skv, d2 = k.shape
    if B2 != B or d2 != d or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"serve q {tuple(q.shape)} (same B and d, H a "
                         f"multiple of Hkv)")
    q_blk, kv_blk = min(q_blk, Sq), min(kv_blk, Skv)
    if Sq % q_blk or Skv % kv_blk:
        raise ValueError(f"flash_attention: Sq {Sq} and Skv {Skv} are not "
                         f"whole tiles of {q_blk} and {kv_blk}")
    return dev


def _lse(m, l):
    """The rows' logsumexp from their final running max and sum."""
    return m + torch.log(torch.clamp(l, min=1e-30))


def flash_attention_plain(q, k, v, *, causal=True, q_blk=128, kv_blk=128,
                          with_lse=False):
    """The prefill kernels' arithmetic in PyTorch: float32 throughout, the
    kv axis walked in the routed kernel's tiles (``TC_KV_TILE`` keys on
    the ``"tc"`` route, ``KV_TILE`` otherwise) with the same online
    softmax (masked scores ``-1e30``, output ``acc / max(l, 1e-30)``).
    When the call's route is ``"tc"``, p is rounded to
    bfloat16 before the product with v, as the tensor-core kernel rounds
    it (its sum ``l`` stays float32).  Tiles above every query's diagonal
    are skipped, as the kernels skip them tile by tile.  ``with_lse``
    returns ``(out, lse)``."""
    _check(q, k, v, q_blk, kv_blk)
    round_p = route(q, k, v) == "tc"
    tile = TC_KV_TILE if round_p else KV_TILE
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(B, Hkv, g, Sq, d).float()
    kf, vf = k.float(), v.float()
    m = torch.full((B, Hkv, g, Sq), NEG_INF, device=q.device)
    l = torch.zeros(B, Hkv, g, Sq, device=q.device)
    acc = torch.zeros(B, Hkv, g, Sq, d, device=q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kend = min(Skv, Sq) if causal else Skv
    for k0 in range(0, kend, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale
        if causal:
            kpos = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                   vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, H, Sq, d).to(q.dtype)
    if with_lse:
        return out, _lse(m, l).reshape(B, H, Sq)
    return out


def _fold(m, l, acc, dim):
    """Fold partials ``(m, l, acc)`` along ``dim`` in index order, as the
    decode kernel folds its warps and then its parts: ``M = max m``, ``l
    = sum l e^(m - M)``, ``acc = sum acc e^(m - M)``."""
    top = m.amax(dim)
    l_all, acc_all = torch.zeros_like(l.select(dim, 0)), None
    for i in range(m.shape[dim]):
        w = torch.exp(m.select(dim, i) - top)
        l_all = l_all + l.select(dim, i) * w
        part = acc.select(dim, i) * w[..., None]
        acc_all = part if acc_all is None else acc_all + part
    return top, l_all, acc_all


def flash_decode_plain(q, k, v, *, causal=True, q_blk=128, kv_blk=128,
                       with_lse=False):
    """The decode kernel's arithmetic in PyTorch, float32 throughout: a kv
    group's ``(H // Hkv) * Sq`` rows together; the kv axis cut into the
    kernel's parts (:func:`decode_split`: cluster ranks in bfloat16,
    splits in float32), each part's keys into tiles of ``DECODE_WARPS *
    decode_tile`` keys and each tile into its warps' ``decode_tile`` keys;
    each warp's online softmax over its keys, tile by tile (masked scores
    ``-1e30``, their p 0, as a key past the cache's end); then each part's
    warps folded in warp order and the parts in part order (``M = max
    m``, ``l = sum l e^(m - M)``, ``acc = sum acc e^(m - M)``), ``acc /
    max(l, 1e-30)``; ``with_lse`` returns
    ``(out, M + log(max(l, 1e-30)))``."""
    _check(q, k, v, q_blk, kv_blk)
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    R = (H // Hkv) * Sq
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    # row r of a group is head r // Sq of the group, query r % Sq
    qf = q.reshape(B, Hkv, R, d).float()
    parts, per = decode_split(B, Hkv, Skv, q.dtype, d)
    W, tw = DECODE_WARPS[q.dtype], decode_tile(q.dtype, d)
    nt = per // (W * tw)
    # keys as [part, tile, warp, key of the warp's], padded past Skv
    pad = parts * per - Skv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    kf = kf.reshape(B, Hkv, parts, nt, W, tw, d)
    vf = vf.reshape(B, Hkv, parts, nt, W, tw, d)
    kpos = torch.arange(parts * per, device=dev).reshape(parts, nt, W, tw)
    qpos = (torch.arange(R, device=dev) % Sq)[:, None]
    m = torch.full((B, Hkv, parts, W, R), NEG_INF, device=dev)
    l = torch.zeros(B, Hkv, parts, W, R, device=dev)
    acc = torch.zeros(B, Hkv, parts, W, R, d, device=dev)
    for t in range(nt):
        s = torch.einsum("bhrd,bhcwkd->bhcwrk", qf, kf[:, :, :, t]) * scale
        keys = kpos[:, t][:, :, None, :]            # [parts, W, 1, tw]
        seen = keys < Skv
        if causal:
            seen = seen & (qpos >= keys)
        s = torch.where(seen, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(seen, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhcwrk,bhcwkd->bhcwrd",
                                                   p, vf[:, :, :, t])
        m = m_new
    m, l, acc = _fold(m, l, acc, 3)                 # the warps of a part
    m, l, acc = _fold(m, l, acc, 2)                 # the parts
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, H, Sq, d).to(q.dtype)
    if with_lse:
        return out, _lse(m, l).reshape(B, H, Sq)
    return out


def plain(q, k, v, *, causal=True, q_blk=128, kv_blk=128, with_lse=False):
    """The plain version of the kernel that :func:`route` picks."""
    fn = (flash_decode_plain if route(q, k, v) == "decode"
          else flash_attention_plain)
    return fn(q, k, v, causal=causal, q_blk=q_blk, kv_blk=kv_blk,
              with_lse=with_lse)


def flash_attention(q, k, v, *, causal=True, q_blk=128, kv_blk=128,
                    with_lse=False):
    """q: [B, H, Sq, d]; k, v: [B, Hkv, Skv, d] with H % Hkv == 0.
    Launches the kernel that :func:`route` picks for tensors on the card
    (``d`` up to 128); runs its plain version (:func:`plain`) for tensors
    on the CPU.  ``with_lse`` returns ``(out, lse)``, ``lse`` float32
    ``[B, H, Sq]``."""
    dev = _check(q, k, v, q_blk, kv_blk)
    if dev.type == "cpu":
        return plain(q, k, v, causal=causal, q_blk=q_blk, kv_blk=kv_blk,
                     with_lse=with_lse)
    B, H, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if d > MAX_D:
        raise ValueError(f"flash_attention: head width {d} exceeds the "
                         f"kernels' {MAX_D}")
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
           if with_lse else None)
    if not out.numel():
        return (out, lse) if with_lse else out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    lse_ptr = lse.data_ptr() if with_lse else None
    scale = 1.0 / math.sqrt(d)
    which = route(q, k, v)
    if which == "decode":
        parts, per = decode_split(B, Hkv, Skv, q.dtype, d)
        scratch = (None,) * 3
        if q.dtype != torch.bfloat16:
            # the split-kv kernel's (m, l, acc) a row a split, merged by
            # its second kernel
            rows = B * H * Sq * parts
            scratch = tuple(t.data_ptr() for t in (
                torch.empty(rows, device=dev), torch.empty(rows, device=dev),
                torch.empty(rows, d, device=dev)))
        KERNEL_DECODE(*ptrs, *scratch, B, H, Hkv, Sq, Skv, d, int(causal),
                      scale, parts, per, decode_tile(q.dtype, d),
                      dtype_code("flash_attention", q), lse_ptr, device=dev)
    elif which == "tc":
        KERNEL_TC(*ptrs, B, H, Hkv, Sq, Skv, d, int(causal), scale,
                  TC_KV_TILE, lse_ptr, device=dev)
    else:
        KERNEL(*ptrs, B, H, Hkv, Sq, Skv, d, int(causal), scale,
               dtype_code("flash_attention", q), lse_ptr, device=dev)
    return (out, lse) if with_lse else out
