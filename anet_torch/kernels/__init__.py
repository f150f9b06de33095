"""Hand-written CUDA kernels of the receiver's main paths, with their plain
PyTorch versions (mirrors all fourteen ``anet.kernels`` Pallas kernels: those
the aligned, streaming and one-shot receivers run, MFSK uncoded and coded,
fixed and variable frame length, int8 quantized ingest and the OFDM
equalizer; the batch-major filterbank of ``frame.demodulate_frame``; and the
block maxima of the two-phase acquisition search).

| wrapper                 | kernel source                       | TPU kernel it replaces        |
|-------------------------|-------------------------------------|-------------------------------|
| decide_frame_tm         | csrc/decide_frame_tm.cu             | anet/kernels/__init__.py:488  |
|                         | + csrc/frame_tm_any.cu              |                               |
| sync_search_fused       | csrc/sync_search.cu                 | anet/kernels/__init__.py:1095 |
| demod_at_fused          | csrc/demod_at.cu                    | anet/kernels/__init__.py:1992 |
|                         | + csrc/demod_at_any.cu              |                               |
| demod_probe_fused       | csrc/demod_probe.cu + demod_at.cu   | anet/kernels/__init__.py:2307 |
|                         | + csrc/demod_at_any.cu              |                               |
| viterbi_trellis         | csrc/viterbi.cu                     | anet/kernels/__init__.py:754  |
| demod_at_energies_fused | csrc/demod_at_energies.cu           | anet/kernels/__init__.py:1918 |
|                         | + csrc/demod_at_any.cu              |                               |
| probe_at_fused          | csrc/demod_probe.cu                 | anet/kernels/__init__.py:1621 |
| correlate_fused         | csrc/correlate.cu                   | anet/kernels/__init__.py:891  |
| decide_tones_tm         | csrc/decide_frame_tm.cu             | anet/kernels/__init__.py:269  |
|                         | + csrc/frame_tm_any.cu              |                               |
| gather_rows_fused       | csrc/gather_rows.cu                 | anet/kernels/__init__.py:1415 |
| ofdm_track_decide_fused | csrc/ofdm_track.cu                  | anet/kernels/__init__.py:2648 |
| tone_energies_fused     | csrc/tone_energies.cu               | anet/kernels/__init__.py:87   |
|                         | + csrc/filterbank_any.cu            |                               |
| decide_tones_fused      | csrc/tone_energies.cu               | anet/kernels/__init__.py:172  |
|                         | + csrc/filterbank_any.cu            |                               |
| sync_search_blockmax    | csrc/search_blockmax.cu             | anet/kernels/__init__.py:1300 |

Each wrapper runs its plain version (``*_ref``) when its tensors lie on the
CPU, and launches its CUDA kernel when they lie on the card: it checks
device, dtype (float32 or bfloat16 samples, and int8 for the four kernels
of the quantized paths; complex64 OFDM symbol estimates; any 1-, 2- or
4-byte element for gather_rows_fused, which only moves them), shape and
contiguity, allocates the outputs, launches on
``torch.cuda.current_stream()``, raises if the launch reported an error, and
adds one to ``launch_counts[name]`` (``launch_counts[name + ":int8"]`` for
an int8 launch, ``launch_counts[name + ":f32"]`` for a launch of the
float32 route of a kernel in ``F32_ROUTES``: float32 data, or float32
compute for the batch-major filterbank); a launch of a body off the
compile-time walks' geometry counts under the body's own key instead
(``OFF_WALK_KEYS``: ``frame_tm_any``, ``filterbank_any``,
``demod_at_any``). There is no fallback from the kernel to the plain
version.

The two search kernels and correlate_fused share one product on the
tensor cores (``csrc/search_core.cuh``: bf16 ``mma.sync`` with float32
accumulators, a float32 operand split into bf16 hi + lo, so each product
is the float32 one to about 2**-16); the wrappers build the template
operand once a template tensor. A template too long for a block's shared
memory (past about 14,400 samples in float32) takes the same product in
slabs of k-steps, its sums folded into a float32 sum every 32 k-steps. The two align+demod kernels
(demod_at_fused, demod_at_energies_fused) share another
(``csrc/demod_core.cuh``): the filterbank as a bf16 ``mma.sync`` with
float32 accumulators, or an int8 one with exact int32 I/Q, fed by a
pipelined span read, the basis packed once a config and dtype in fragment
order (``_demod_mma_basis``). Their float32 buffers (the stream's
default carry) take the float32 basis as three bf16 terms that sum to it
exactly (``_demod_split_basis``) and their samples split on load into
three bf16 terms of their own, six of the nine products kept, so the I/Q
are float32 sums to about 2**-24 (``F32_SPLIT_RTOL``, ``F32_SPLIT_ATOL``);
``_demod_at_basis`` picks the basis for both. Their walk takes sps 32, 64
and 128 with at most 16 tones (``_tensor_core_geometry``); the rest of the
reference's gate, 128 % sps == 0 (``_demod_at_geometry``: sps 4, 8 and 16,
32 or 64 tones at sps 64 and 128), takes the same products with the
geometry known at run time (csrc/demod_at_any.cu: r = 16 / sps symbols an
A row below a k-step, against a block-diagonal basis, as the reference
packs 128 / sps a row; groups of 32 tones; the basis from
``_demod_at_any_basis``; the route: ``_demod_at_operands``). The
batch-major filterbank (tone_energies_fused, decide_tones_fused) runs that
product, with the same two epilogues, on rows read in place from every start 0 at sps 32,
48, 64, 80 and 128 with at most 32 tones (8 n-tiles, the basis then in
shared memory): under bfloat16 compute with the bf16 basis; under float32
compute with the three-term split, bfloat16 rows meeting all three terms
and float32 rows split as demod_at_fused's are (the route:
``_filterbank_operands`` on ``_filterbank_tensor_core_geometry``). Every
other geometry (any sps, any tone count) takes the same products with the
geometry known at run time (csrc/filterbank_any.cu: symbols walked in
k-slabs, groups of 32 tones, the basis from ``_filterbank_any_basis``).
demod_probe_fused is a warp-per-stream probe followed by demod_at_fused's
kernel, every dtype;
probe_at_fused runs the same staged probe (csrc/demod_probe.cu) with its
span at the probe base and the quality as its epilogue, the template
energy read on the card.
ofdm_track_decide_fused is a warp per stream over points staged in shared
memory where that keeps enough warps an SM (short frames), else a block of
warps per stream (4 streams a block in the time-major view), each warp on a
run of symbols, summed in warp order (``_ofdm_track_route``, by the staged
route's occupancy).
decide_frame_tm runs the same tensor-core filterbank with streams on the
product's M axis, its A operand staged from time-major rows (bfloat16 and
int8 read with ``ldmatrix.trans``; float32 frames with 32-bit loads, each
sample split into three bf16 terms against ``_demod_split_basis``, the
align+demod kernels' float32 product), and counts CRC bits with popcounts
of the packed words; decide_tones_tm takes the same walk with a decisions
epilogue, bfloat16 and float32 data alike. decide_frame_tm's walk takes
sps 32, 64 and 128 with at most 16 tones (_tensor_core_geometry, which
also picks the align+demod kernels' and the stream steps' routes);
decide_tones_tm's also sps 48 and 80 and up to 32 tones (8 n-tiles, the
basis in shared memory). At every other geometry both take the same
products with the geometry known at run time (csrc/frame_tm_any.cu: short
symbols several a ring stage, long ones walked in k-slabs, groups of 32
tones, the basis from ``_filterbank_any_basis``; the route:
``_tm_operands``). Which predicate picks which route: _tensor_core_geometry
the align+demod kernels' walk and decide_frame_tm's; _demod_at_geometry
(the reference's 128 % sps == 0) the stream steps' fused routes;
_filterbank_tensor_core_geometry the batch-major filterbank and
decide_tones_tm; _ofdm_track_route, from S and C, the OFDM equalizer's.
gather_rows_fused copies 16-byte vectors aligned by a funnel shift. The
other kernels sum in float32 on the CUDA cores.

The plain versions widen every operand to float32 before a product, as the
reference kernels accumulate in float32. On the card, a float32 product
there must run with ``torch.backends.cuda.matmul.allow_tf32 = False`` (the
PyTorch default), or it rounds its operands to TF32.

int8 samples (``decide_frame_tm``, ``demod_at_fused``,
``demod_at_energies_fused``, ``demod_probe_fused``) meet the reference's
x127 integer basis, ``round(basis * 127)``; the probe's template is
quantized to ``round(t * 127 / max|t|)`` and ``cmax`` scaled back by
``max|t| / 127``. The reference accumulates those products in int32. Every
I/Q sum stays below 2**24, so float32 sums are exact; the probe's
correlation and window energy can pass 2**24 and sum in int32 (the plain
version's correlation in float64, its energy in float32, exact below
2**24). Energies are I*I + Q*Q rounded after each operation, bit-equal to
the reference's, so the first-index argmax breaks the frequent integer ties
alike. (The align+demod kernels' int8 products run on the tensor cores in
int32, the same exact sums.) Energies then carry the (127 * buffer
scale)**2 factor, which every decision and quality ratio cancels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from anet_torch.dsp.demod import demod_basis
from anet_torch.dsp.params import ModemConfig

__all__ = [
    "TM_SYMBOL_TILE",
    "F32_ROUTES",
    "F32_SPLIT_RTOL",
    "F32_SPLIT_ATOL",
    "launch_counts",
    "reset_launch_counts",
    "decide_frame_tm",
    "decide_frame_tm_ref",
    "sync_search_fused",
    "sync_search_fused_ref",
    "demod_at_fused",
    "demod_at_fused_ref",
    "demod_probe_fused",
    "demod_probe_fused_ref",
    "demod_at_buffer_pad",
    "viterbi_trellis",
    "viterbi_trellis_ref",
    "demod_at_energies_fused",
    "demod_at_energies_fused_ref",
    "probe_at_fused",
    "probe_at_fused_ref",
    "correlate_fused",
    "correlate_fused_ref",
    "decide_tones_tm",
    "decide_tones_tm_ref",
    "gather_rows_fused",
    "gather_rows_fused_ref",
    "ofdm_track_decide_fused",
    "ofdm_track_decide_fused_ref",
    "tone_energies_fused",
    "tone_energies_fused_ref",
    "decide_tones_fused",
    "decide_tones_fused_ref",
    "sync_search_blockmax",
    "sync_search_blockmax_ref",
]

TM_SYMBOL_TILE = 8  # Gray-decoded symbols packed per int32 word
_ROW = 128  # samples per row of the probe's row-aligned energy span
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KERNEL_SPS = (32, 64, 128)
INT8_BASIS_SCALE = 127.0  # int8 basis and probe template: round(x * 127 / max|x|)
# The three-term split on the tensor cores (the batch-major filterbank's
# float32 compute, the float32 buffers of demod_at_fused, demod_probe_fused
# and demod_at_energies_fused, the float32 frames of decide_frame_tm and
# decide_tones_tm) against its plain version: each energy
# within F32_SPLIT_RTOL of itself plus F32_SPLIT_ATOL of its symbol's
# largest plain energy; best and total within the same bounds, tones equal
# but where the plain version's two largest energies lie that close.
F32_SPLIT_RTOL = 1e-5
F32_SPLIT_ATOL = 1e-6

# Launches of each kernel since the last reset_launch_counts(): the proof
# that a run went through the kernels. Only the CUDA branch of a wrapper
# counts; the plain versions never do.
launch_counts = {
    "decide_frame_tm": 0,
    "sync_search_fused": 0,
    "demod_at_fused": 0,
    "demod_probe_fused": 0,
    "viterbi_trellis": 0,
    "demod_at_energies_fused": 0,
    "probe_at_fused": 0,
    "correlate_fused": 0,
    "decide_tones_tm": 0,
    "gather_rows_fused": 0,
    "ofdm_track_decide_fused": 0,
    "tone_energies_fused": 0,
    "decide_tones_fused": 0,
    "sync_search_blockmax": 0,
    # the int8 instantiations, counted apart from their float launches
    "decide_frame_tm:int8": 0,
    "demod_at_fused:int8": 0,
    "demod_at_energies_fused:int8": 0,
    "demod_probe_fused:int8": 0,
    "gather_rows_fused:int8": 0,
    # the bodies off the compile-time walks' geometry, counted apart from
    # the walks at their launch (OFF_WALK_KEYS)
    "frame_tm_any": 0,
    "frame_tm_any:int8": 0,
    "filterbank_any": 0,
    "demod_at_any": 0,
    "demod_at_any:int8": 0,
    # the OFDM equalizer's block-of-warps route for long streams
    # (_ofdm_track_route), counted apart from the staged one
    "ofdm_track_decide_fused:block": 0,
}
# The kernels whose float32 route is a design of its own, counted apart
# under "<name>:f32": the searches' and the correlation's hi + lo split of
# a float32 segment, or the three-term split of the align+demod kernels
# (float32 buffers), the time-major pair (float32 frames) and the
# batch-major filterbank (float32 compute).
F32_ROUTES = (
    "decide_frame_tm", "sync_search_fused", "demod_at_fused", "demod_probe_fused",
    "demod_at_energies_fused", "correlate_fused", "decide_tones_tm", "tone_energies_fused",
    "decide_tones_fused", "sync_search_blockmax", "frame_tm_any", "filterbank_any", "demod_at_any",
)
# The launch-count key of each route off the compile-time walks: the
# time-major pair's runtime-geometry routes "tm_any" and "tm_any_split"
# (_tm_operands; csrc/frame_tm_any.cu), the batch-major filterbank's
# "any" and "any_split" (_filterbank_operands; csrc/filterbank_any.cu) and
# the align+demod kernels' "at_any" (_demod_at_operands;
# csrc/demod_at_any.cu), whichever wrapper launched them.
OFF_WALK_KEYS = {
    "tm_any": "frame_tm_any", "tm_any_split": "frame_tm_any",
    "any": "filterbank_any", "any_split": "filterbank_any",
    "at_any": "demod_at_any",
}
launch_counts.update({f"{name}:f32": 0 for name in F32_ROUTES})


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _count_launch(name: str, dtype: torch.dtype | None = None, route: str | None = None) -> None:
    """Count a launch of ``name`` on ``route``: under OFF_WALK_KEYS[route]
    for a route off the compile-time walks, else under ``name``; then
    ":int8" or ":f32" by the dtype."""
    name = OFF_WALK_KEYS.get(route, name)
    if dtype == torch.int8:
        name = f"{name}:int8"
    elif dtype == torch.float32 and name in F32_ROUTES:
        name = f"{name}:f32"
    launch_counts[name] += 1


def _check_launch(err: int, name: str, dtype: torch.dtype | None = None, route: str | None = None) -> None:
    _check_error(err, name)
    _count_launch(name, dtype, route)


def _check_on_card(name: str, t: torch.Tensor, what: str) -> None:
    """Check that ``t`` lies on the card with a contiguous last dimension."""
    if not t.is_cuda:
        raise ValueError(f"{name}: {what} must be a CUDA tensor, got {t.device}")
    if t.stride(-1) != 1 and t.shape[-1] > 1:  # a size-1 dimension's stride is arbitrary
        raise ValueError(f"{name}: {what} must be contiguous in its last dimension")


def _check_cuda_input(name: str, t: torch.Tensor, what: str, int8: bool = False) -> int:
    """The kernel's dtype code of ``t``, after checking that it lies on the
    card, in a dtype the kernel takes (int8 only where ``int8``), with a
    contiguous last dimension."""
    _check_on_card(name, t, what)
    if t.dtype not in _KERNEL_DTYPES or (t.dtype == torch.int8 and not int8):
        kinds = "float32, bfloat16 or int8" if int8 else "float32 or bfloat16"
        raise TypeError(f"{name}: {what} must be {kinds}, got {t.dtype}")
    return _KERNEL_DTYPES[t.dtype]


def _check_buffer_and_starts(
    name: str, buffer: torch.Tensor, starts: torch.Tensor, what: str, int8: bool = True
):
    """Checks of the kernels that index a [B, L] stream buffer (float32,
    bfloat16, and int8 unless ``int8`` is false) at per-stream positions:
    (dtype code, ``starts`` as contiguous int32 [B] on the card)."""
    dtype = _check_cuda_input(name, buffer, "buffer", int8=int8)
    if buffer.dim() != 2 or not buffer.is_contiguous():
        raise ValueError(f"{name}: buffer must be a contiguous [B, L] tensor")
    b = buffer.shape[0]
    st = starts.to(device=buffer.device, dtype=torch.int32).contiguous()
    if st.shape != (b,):
        raise ValueError(f"{name}: {what} must be [B] = [{b}], got {tuple(st.shape)}")
    return dtype, st


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _entry(name: str):
    from anet_torch.kernels.build import entry

    return entry(name)


def _plain_basis(config: ModemConfig, dtype: torch.dtype, device) -> torch.Tensor:
    """[sps, 2M] float32 basis that meets samples of ``dtype``: entries
    rounded to ``dtype`` first, as the reference casts its basis to the input
    dtype; for int8 samples the reference's x127 integer basis (phases in
    float32, then round(basis * 127))."""
    if dtype == torch.int8:
        return torch.round(demod_basis(config, device=device) * INT8_BASIS_SCALE)
    return demod_basis(config, dtype=dtype, device=device).float()


@functools.lru_cache(maxsize=16)
def _kernel_basis(config: ModemConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[sps, 32] float32 basis: cos of the num_tones tones in columns 0..15
    and sin in 16..31, zero columns for tones past num_tones; entries as
    _plain_basis gives them for samples of ``dtype``. No kernel takes it:
    the tests hold the tensor-core operands (_demod_mma_basis,
    _demod_split_basis) to it."""
    m = config.num_tones
    basis = _plain_basis(config, dtype, device)  # [sps, 2M]
    out = torch.zeros(config.samples_per_symbol, 32, dtype=torch.float32, device=device)
    out[:, :m] = basis[:, :m]
    out[:, 16 : 16 + m] = basis[:, m:]
    return out


def _demod_mma_tiles(num_tones: int) -> int:
    """n8 tiles of demod_core.cuh's tensor-core product: 4 tones' (I, Q) a
    tile; 8 tiles (17 to 32 tones) only on the batch-major filterbank's
    routes and decide_tones_tm's, the other walks taking at most 16 tones."""
    return 1 if num_tones <= 4 else 2 if num_tones <= 8 else 4 if num_tones <= 16 else 8


def _mma_fragments(config: ModemConfig, plain: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The [sps, 2M] basis ``plain`` (entries exact in ``dtype``, bfloat16
    or int8) as the B fragments of csrc/demod_core.cuh, int32 [ks, n, 2, 32]
    with n = _demod_mma_tiles(num_tones): the [sps, 8 n] basis whose column
    2c is the cos (I) and 2c + 1 the sin (Q) of tone c, zero columns past
    num_tones. Word [s, t, r, 4 g + i] is the B fragment register r of lane
    (g, i) at k-step s and n8 tile t; a k-step is 32 bytes of samples: for
    bfloat16 (m16n8k16) the word holds the bf16 pair at rows k = 16 s + 8 r
    + 2 i + (0, 1), column 8 t + g, the first in the low half; for int8
    (m16n8k32, the x127 integer basis) the 4 bytes at rows 32 s + 16 r + 4 i
    + (0..3), the first in the low byte."""
    m, sps = config.num_tones, config.samples_per_symbol
    n = _demod_mma_tiles(m)
    basis = torch.zeros(sps, 8 * n, dtype=torch.float32, device=plain.device)
    basis[:, 0 : 2 * m : 2] = plain[:, :m]
    basis[:, 1 : 2 * m : 2] = plain[:, m:]
    if dtype == torch.int8:
        v = basis.to(torch.int8).reshape(sps // 32, 2, 4, 4, n, 8)
    elif dtype == torch.bfloat16:
        v = basis.to(torch.bfloat16).reshape(sps // 16, 2, 4, 2, n, 8)
    else:
        raise TypeError(f"the tensor-core filterbank takes bfloat16 or int8 samples, got {dtype}")
    # [s, r, i, e, t, g] -> [s, t, r, g, i, e]: a word's elements e last
    return v.permute(0, 4, 1, 5, 2, 3).contiguous().view(torch.int32).reshape(-1, n, 2, 32)


@functools.lru_cache(maxsize=16)
def _demod_mma_basis(config: ModemConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The B operand of the align+demod kernels' tensor-core product
    (csrc/demod_core.cuh's OneTerm) for bfloat16 or int8 samples:
    _mma_fragments of the basis with the entries _plain_basis gives for
    samples of ``dtype``."""
    return _mma_fragments(config, _plain_basis(config, dtype, device), dtype)


def _split_terms(b: torch.Tensor, n_terms: int = 3) -> list[torch.Tensor]:
    """float32 ``b`` as bf16 terms, each the bf16 rounding (to nearest) of
    what the ones before it left: b0 = bf16(b), b1 = bf16(b - b0), b2 =
    bf16(b - b0 - b1). Each remainder is exact in float32, and three terms
    sum to every normal float32 exactly (8 + 8 + 8 bits of its 24). Returned
    as float32 tensors of bf16 values."""
    terms, rest = [], b
    for _ in range(n_terms):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


@functools.lru_cache(maxsize=16)
def _demod_split_basis(config: ModemConfig, device: torch.device) -> torch.Tensor:
    """The B operand of float32 compute on the tensor cores
    (csrc/demod_core.cuh's SplitTerms): the float32 basis
    _plain_basis(config, float32), the CUDA-core kernels' entries, as three
    bf16 terms that sum to it exactly (_split_terms), each in
    _demod_mma_basis's fragment order: int32 [3, ks, n, 2, 32]."""
    terms = _split_terms(_plain_basis(config, torch.float32, device))
    return torch.stack([_mma_fragments(config, t, torch.bfloat16) for t in terms])


def _demod_at_basis(config: ModemConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The basis operand of the kernels whose product follows the samples'
    dtype (demod_at.cu's and demod_at_energies.cu's: demod_at_fused,
    demod_probe_fused's demod, demod_at_energies_fused; decide_frame_tm.cu's:
    decide_frame_tm, decide_tones_tm) for samples of ``dtype``: the one-term
    B fragments for bfloat16 and int8, the three-term split of the float32
    basis for float32."""
    if dtype == torch.float32:
        return _demod_split_basis(config, device)
    return _demod_mma_basis(config, dtype, device)


def _tensor_core_geometry(config: ModemConfig) -> bool:
    """The geometry of the align+demod kernels' compile-time walk
    (demod_at.cu, demod_at_energies.cu) and of decide_frame_tm's
    time-major walk: sps in _KERNEL_SPS (whole k-steps of 32 int8 samples,
    the align+demod span rows) and at most 16 tones (four n8 tiles). It
    picks between the two walks of the align+demod kernels
    (_demod_at_operands: demod_at_any.cu off it) and decide_frame_tm's
    route (_tm_operands). The stream steps ask the reference's gate,
    _demod_at_geometry; the batch-major filterbank and decide_tones_tm
    _filterbank_tensor_core_geometry."""
    return config.samples_per_symbol in _KERNEL_SPS and config.num_tones <= 16


def _demod_at_geometry(config: ModemConfig) -> bool:
    """The reference's gate of its align+demod kernels (_demod_at_setup)
    and of the stream routes that fuse them: 128 % sps == 0, any tone
    count. Every geometry in it has a route on the card
    (_demod_at_operands). It picks the stream steps' route (the
    align+demod kernels, else the aligned slice and the batch-major
    filterbank), the merged lock step and the resident scan."""
    return 128 % config.samples_per_symbol == 0


_FILTERBANK_SPS = (32, 48, 64, 80, 128)  # whole k-steps of 16 bf16 samples, rows of whole 32 bytes


def _filterbank_tensor_core_geometry(config: ModemConfig) -> bool:
    """The geometry of the tensor-core walks whose k-steps are 16 bf16
    samples (float32 ones split into bf16 terms) and whose basis may lie in
    shared memory: sps in _FILTERBANK_SPS and at most 32 tones (eight n8
    tiles), mfsk8-audible (sps 48, 8 tones) and mfsk32-dense (sps 80, 32
    tones) among them. The batch-major filterbank's routes
    (_filterbank_operands: tone_energies.cu's walk) and decide_tones_tm's
    (_tm_operands: decide_frame_tm.cu's walk, its decisions epilogue) ask
    it; the align+demod kernels and decide_frame_tm keep
    _tensor_core_geometry."""
    return config.samples_per_symbol in _FILTERBANK_SPS and config.num_tones <= 32


def _demod_at_operands(name: str, kind: str, config: ModemConfig, dtype: torch.dtype,
                       device) -> tuple[str, str, torch.Tensor]:
    """(entry point, route, basis) of an align+demod launch of ``kind``,
    "demod_at" (decisions: demod_at_fused, demod_probe_fused's demod) or
    "demod_at_energies", on a buffer of ``dtype``, picked from the config
    before the launch. At _tensor_core_geometry, the compile-time walk
    (demod_at.cu, demod_at_energies.cu; entry ``kind``) with
    _demod_at_basis: route "mma" for bfloat16 and int8 buffers, "split"
    for float32 (the three-term bf16 split). Elsewhere within the
    reference's gate (_demod_at_geometry: sps 4, 8 and 16, or more than 16
    tones at sps 64 and 128), csrc/demod_at_any.cu's walk with the
    geometry known at run time (entry ``kind + "_any"``, route "at_any",
    counted under OFF_WALK_KEYS["at_any"]) with _demod_at_any_basis.
    Where 128 % sps != 0, ValueError naming sps, as the reference's
    _demod_at_setup raises."""
    if _tensor_core_geometry(config):
        return kind, "split" if dtype == torch.float32 else "mma", _demod_at_basis(config, dtype, device)
    if not _demod_at_geometry(config):
        raise ValueError(f"{name}: the kernel needs 128 % samples_per_symbol == 0, "
                         f"got samples_per_symbol {config.samples_per_symbol}")
    return f"{kind}_any", "at_any", _demod_at_any_basis(config, dtype, device)


def _decisions(config: ModemConfig, iq: torch.Tensor, dim: int):
    """(tone, best, total) from I/Q [..., 2M, ...] along ``dim``. I*I + Q*Q
    are separate operations here (no fused multiply-add), as in the kernels."""
    m = config.num_tones
    i, q = iq.narrow(dim, 0, m), iq.narrow(dim, m, m)
    e = i * i + q * q
    return torch.argmax(e, dim=dim).to(torch.int32), e.amax(dim), e.sum(dim)


# --- the time-major pair's routes ---------------------------------------------


def _tm_operands(name: str, config: ModemConfig, dtype: torch.dtype,
                 device) -> tuple[str, str, torch.Tensor]:
    """(entry point, route, basis) of a time-major launch of ``name``,
    "decide_frame_tm" or "decide_tones_tm", on samples of ``dtype``. Where
    the wrapper's walk takes the geometry, csrc/decide_frame_tm.cu's walk
    with _demod_at_basis: route "mma" for bfloat16 and int8 samples,
    "split" for float32 (the three-term bf16 split). decide_frame_tm's
    walk takes _tensor_core_geometry (its int8 k-steps are 32 samples, and
    its words at most 4 bits a symbol), decide_tones_tm's the wider
    _filterbank_tensor_core_geometry (sps 48 and 80, up to 32 tones: both
    presets off the other walks). Any other geometry takes
    csrc/frame_tm_any.cu, the same products with the geometry known at run
    time (entry ``name + "_any"``; route "tm_any" for bfloat16 and int8
    samples, "tm_any_split" for float32) with _filterbank_any_basis, whose
    launches count under OFF_WALK_KEYS["tm_any"] whichever wrapper launched
    them. The sets match the kernels' instantiations, so no launch on the
    walk is refused."""
    walk = _filterbank_tensor_core_geometry if name == "decide_tones_tm" else _tensor_core_geometry
    split = dtype == torch.float32
    if walk(config):
        entry = name if name == "decide_frame_tm" else f"{name}_mma"
        return entry, "split" if split else "mma", _demod_at_basis(config, dtype, device)
    return f"{name}_any", "tm_any_split" if split else "tm_any", _filterbank_any_basis(config, dtype, device)


# --- decide_frame_tm: the aligned receiver's full fusion ---------------------


def _frame_crc_rows(payload_len: int, n_rows: int) -> tuple[np.ndarray, int, int]:
    """P [n_rows, 64] in message-bit row order (row r = bit r of the data
    section, MSB-first), with the xor consts: columns 0..31 hold the header
    checksum's rows (crc32 over section bytes 0..5), columns 32..63 the
    payload checksum's (bytes 8..8+payload_len); zero elsewhere."""
    from anet_torch.dsp.fec import _crc32_bit_table
    from anet_torch.dsp.frame import HEADER_BYTES

    p = np.zeros((n_rows, 64), np.float32)
    p_hdr, c_hdr = _crc32_bit_table(6)
    p[: 6 * 8, :32] = p_hdr
    p_pay, c_pay = _crc32_bit_table(payload_len)
    lo = HEADER_BYTES * 8
    p[lo : lo + payload_len * 8, 32:] = p_pay
    return p, int(c_hdr), int(c_pay)


@functools.lru_cache(maxsize=32)
def _frame_crc_tables(payload_len: int, n_tiles: int, nb: int):
    """(P [n_tiles * nb, 64] f32, hdr_const, pay_const), rows in the
    reference kernel's bit-major tile order: within tile i, row k * sb + s
    is message bit (i*sb + s) * bps + k. Identical to
    anet.kernels._frame_crc_tables; here the plain version uses the
    bit-order table (_frame_crc_rows) and the kernel its packed-word masks
    (_frame_crc_mask_table), which give the same counts."""
    p, c_hdr, c_pay = _frame_crc_rows(payload_len, n_tiles * nb)
    sb = TM_SYMBOL_TILE
    bps = nb // sb
    idx = np.arange(n_tiles * nb)
    tile, within = idx // nb, idx % nb
    k, s = within // sb, within % sb
    return p[tile * nb + s * bps + k], c_hdr, c_pay


@functools.lru_cache(maxsize=16)
def _crc_rows_tensor(payload_len: int, n_rows: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_frame_crc_rows(payload_len, n_rows)[0], device=device)


def _frame_crc_mask_table(payload_len: int, n_tiles: int, bps: int) -> np.ndarray:
    """uint32 [n_tiles, 64]: the CRC table of _frame_crc_rows by packed word.
    Bit nb - 1 - pos of mask[tile, c] (nb = 8 bps) is P[tile * nb + pos, c],
    the word's bit order (message bit tile * nb + pos sits at bit nb - 1 -
    pos of decide_frame_tm's word), so popc(word & mask[tile, c]) summed
    over tiles is column c's bit count."""
    nb = TM_SYMBOL_TILE * bps
    p = _frame_crc_rows(payload_len, n_tiles * nb)[0].reshape(n_tiles, nb, 64).astype(np.uint64)
    place = np.uint64(1) << (nb - 1 - np.arange(nb, dtype=np.uint64))
    return (p * place[None, :, None]).sum(1).astype(np.uint32)


@functools.lru_cache(maxsize=16)
def _frame_crc_masks(payload_len: int, n_tiles: int, bps: int, device: torch.device) -> torch.Tensor:
    """_frame_crc_mask_table as int32 on ``device``, made once a geometry."""
    table = _frame_crc_mask_table(payload_len, n_tiles, bps)
    return torch.as_tensor(table.view(np.int32), device=device)


def _frame_geometry(config: ModemConfig, t: int, payload_len: int, preamble_offset: int):
    from anet_torch.dsp.frame import data_symbols_for_payload

    bps = config.bits_per_symbol
    if bps not in (1, 2, 4):
        raise ValueError("decide_frame_tm needs bits_per_symbol in {1, 2, 4}")
    s = data_symbols_for_payload(config, payload_len)
    if t - preamble_offset < s * config.samples_per_symbol:
        raise ValueError(
            f"data_tm too short: {t} - {preamble_offset} < {s} symbols x "
            f"{config.samples_per_symbol}"
        )
    n_tiles = -(-s // TM_SYMBOL_TILE)
    return s, n_tiles, TM_SYMBOL_TILE * bps


def decide_frame_tm_ref(
    config: ModemConfig, data_tm: torch.Tensor, payload_len: int, *, preamble_offset: int = 0
):
    """Plain version of decide_frame_tm (same arguments and outputs)."""
    sps = config.samples_per_symbol
    bps = config.bits_per_symbol
    t, b = data_tm.shape
    s, n_tiles, nb = _frame_geometry(config, t, payload_len, preamble_offset)
    dev = data_tm.device
    w = data_tm[preamble_offset : preamble_offset + s * sps].float().reshape(s, sps, b)
    basis_t = _plain_basis(config, data_tm.dtype, dev).T  # [2M, sps]
    tone, best, total = _decisions(config, torch.einsum("mk,skb->smb", basis_t, w), 1)
    data = tone
    shift = 1
    while shift < bps:
        data = data ^ (data >> shift)
        shift <<= 1
    s_pad = n_tiles * TM_SYMBOL_TILE - s
    data = torch.nn.functional.pad(data, (0, 0, 0, s_pad)).to(torch.int64)  # [Sp, B]
    place = (TM_SYMBOL_TILE - 1 - torch.arange(TM_SYMBOL_TILE, device=dev)) * bps
    words = (data.reshape(n_tiles, TM_SYMBOL_TILE, b) << place[None, :, None]).sum(1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    k_shift = torch.arange(bps - 1, -1, -1, device=dev)
    bits = ((data[:, None, :] >> k_shift[None, :, None]) & 1).reshape(n_tiles * nb, b)
    p = _crc_rows_tensor(payload_len, n_tiles * nb, dev).double()
    crc = (p.T @ bits.double()).float()  # exact integer counts
    qual = torch.zeros(8, b, dtype=torch.float32, device=dev)
    qual[0] = (best / total.clamp_min(1e-20)).sum(0)
    qual[1] = best.sum(0)
    qual[2] = total.sum(0)
    return words, crc, qual, s


def decide_frame_tm(
    config: ModemConfig, data_tm: torch.Tensor, payload_len: int, *, preamble_offset: int = 0
):
    """Time-major fused symbol decision with the frame parse folded in.

    ``data_tm`` is [T, B] (float32, bfloat16, or int8 for the quantized
    ingest path) whose data section starts at row ``preamble_offset``: pass
    whole frames with the preamble length and no copy of the data section
    is made. Returns (words int32 [n_tiles, B]:
    TM_SYMBOL_TILE Gray-decoded symbols per word, MSB-first, the last word
    zero-padded; crc_counts f32 [64, B]: header CRC bit counts in rows
    0..31, payload in 32..63, parity taken by the caller; qual f32 [8, B]:
    sums of conf/best/total in rows 0..2; n_symbols).
    Needs bits_per_symbol in {1, 2, 4} and at most 16 tones, any
    samples_per_symbol. On the card (the route: _tm_operands) sps 32, 64 and
    128 take csrc/decide_frame_tm.cu's tensor-core walk, float32 frames as
    the three-term bf16 split (best, total and the quality sums within
    F32_SPLIT_RTOL and F32_SPLIT_ATOL of the plain version's, decisions
    equal but at near-ties); any other sps csrc/frame_tm_any.cu, the same
    products with the geometry known at run time (bfloat16 and int8 frames
    as on the walk; float32 frames the split, within the same bounds)."""
    if data_tm.device.type == "cpu":
        return decide_frame_tm_ref(config, data_tm, payload_len, preamble_offset=preamble_offset)
    return _decide_frame_tm_launch(config, data_tm, payload_len, preamble_offset)


def _decide_frame_tm_launch(config: ModemConfig, data_tm: torch.Tensor, payload_len: int, preamble_offset: int):
    name = "decide_frame_tm"
    dtype = _check_cuda_input(name, data_tm, "data_tm", int8=True)
    if data_tm.dim() != 2 or not data_tm.is_contiguous():
        raise ValueError(f"{name}: data_tm must be a contiguous [T, B] tensor")
    if config.num_tones > 16:  # the reference's bound too: a word holds 8 symbols of at most 4 bits
        raise ValueError(f"{name}: the kernel takes at most 16 tones")
    t, b = data_tm.shape
    s, n_tiles, _ = _frame_geometry(config, t, payload_len, preamble_offset)
    dev = data_tm.device
    sps, bps = config.samples_per_symbol, config.bits_per_symbol
    words = torch.empty(n_tiles, b, dtype=torch.int32, device=dev)
    crc = torch.zeros(64, b, dtype=torch.float32, device=dev)  # the blocks add into them
    qual = torch.zeros(8, b, dtype=torch.float32, device=dev)
    if b == 0:
        return words, crc, qual, s
    entry, route, basis = _tm_operands(name, config, data_tm.dtype, dev)
    masks = _frame_crc_masks(payload_len, n_tiles, bps, dev)
    err = _entry(entry)(
        data_tm.data_ptr(), dtype, b, preamble_offset, sps, config.num_tones, s, n_tiles, bps,
        basis.data_ptr(), masks.data_ptr(), words.data_ptr(), crc.data_ptr(), qual.data_ptr(), _stream_handle(dev),
    )
    _check_launch(err, name, data_tm.dtype, route)
    return words, crc, qual, s


# --- sync_search_fused: acquisition ------------------------------------------


def _search_quality(seg: torch.Tensor, template: torch.Tensor, out_len: int, template_energy):
    """The blockwise match quality float32 [..., out_len] at every lag: the
    plain front of both search kernels."""
    from anet_torch.dsp.sync import blockwise_match_quality, correlate_template

    seg_f = seg.float()
    corr = correlate_template(seg_f, template.float(), method="matmul")[..., :out_len]
    return blockwise_match_quality(seg_f, corr, template.shape[-1], template_energy)


def sync_search_fused_ref(seg: torch.Tensor, template: torch.Tensor, out_len: int, template_energy):
    """Plain version of sync_search_fused: the correlation at every lag,
    blockwise quality, then max and first argmax."""
    q = _search_quality(seg, template, out_len, template_energy)
    return q.amax(-1), torch.argmax(q, dim=-1).to(torch.int32)


_SEARCH_TPL_OFF = 128  # template sample j at copy position j + 128 (search_core.cuh TPL_OFF)
_SEARCH_WORDS: dict = {}  # (id, version) of a template -> (template, its words on the card)


def _search_template_words(template: torch.Tensor) -> torch.Tensor:
    """The search kernels' template operand (csrc/search_core.cuh), int32
    [P, 2, W] on the template's device: P = 1 for a bfloat16 template, P = 2
    for a float32 one (its bf16 hi half, then lo = bf16(t - hi)). With z the
    zero-padded half, z[j + 128] = t[j], copy 0's word w holds the bf16 pair
    (z[2w], z[2w + 1]) and copy 1's (z[2w - 1], z[2w]), the first in the low
    16 bits: every pair (t[e], t[e + 1]) a lane's B fragment takes is one
    aligned word. W = 16 mod 32 covers the ceil((k + 127) / 16) steps of the
    band and the next step's reads."""
    k = template.shape[-1]
    n_steps = -(-(k + 127) // 16)
    w = 8 * n_steps + 72
    w += (16 - w) % 32
    hi = template.to(torch.bfloat16)
    halves = [hi]
    if template.dtype != torch.bfloat16:
        halves.append((template.float() - hi.float()).to(torch.bfloat16))
    out = torch.zeros(len(halves), 2, 2 * w, dtype=torch.bfloat16, device=template.device)
    for i, half in enumerate(halves):
        out[i, 0, _SEARCH_TPL_OFF : _SEARCH_TPL_OFF + k] = half
        out[i, 1, _SEARCH_TPL_OFF + 1 : _SEARCH_TPL_OFF + 1 + k] = half
    return out.view(torch.int32)


def _energy_operand(name: str, template_energy, dev: torch.device):
    """(tensor, value) of a kernel's template energy: a tensor goes by
    address, as a float32 scalar on ``dev`` (no float(), so no host read;
    the caller holds it through the launch and passes its data_ptr()), a
    Python number by value with no tensor (a null pointer)."""
    if not isinstance(template_energy, torch.Tensor):
        return None, float(template_energy)
    te = template_energy
    if te.device != dev or te.dtype != torch.float32:
        te = te.to(device=dev, dtype=torch.float32)
    if te.numel() != 1:
        raise ValueError(f"{name}: template_energy must be a scalar, got {tuple(te.shape)}")
    return te, 0.0


def _address(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _search_launch_args(name: str, seg: torch.Tensor, template: torch.Tensor, out_len: int):
    """Checks of the two search kernels, and their leading C arguments:
    (seg, dtype code, B, row stride, seg_len, template words, b_lo, W, k)."""
    dtype = _check_cuda_input(name, seg, "seg")
    k = template.shape[-1]
    if seg.dim() != 2 or seg.shape[-1] < out_len + k - 1:
        raise ValueError(f"{name}: seg must be [B, >= out_len + k - 1]")
    if template.dtype not in (torch.float32, torch.bfloat16) or template.dim() != 1:
        raise TypeError(f"{name}: template must be a float32 or bfloat16 [k] tensor")
    if template.device != seg.device:
        raise ValueError(f"{name}: template lies on {template.device}, seg on {seg.device}")
    words = _per_template(_SEARCH_WORDS, template, _search_template_words)
    return (seg.data_ptr(), dtype, seg.shape[0], seg.stride(0), seg.shape[-1], words.data_ptr(),
            int(words.shape[0] == 2), words.shape[-1], k)


def sync_search_fused(seg: torch.Tensor, template: torch.Tensor, out_len: int, template_energy):
    """Best blockwise preamble match quality and its first lag, per stream.

    Equivalent to (but never materializing)::

        corr = correlate_template(seg, template)[..., :out_len]
        q = blockwise_match_quality(seg, corr, k, template_energy)
        return q.max(-1), q.argmax(-1)

    ``seg`` is [B, >= out_len + k - 1], float32 or bfloat16; rows may be
    strided (a view into the stream buffer) as long as the last dimension is
    contiguous. ``template`` is float32 or bfloat16 [k]. ``template_energy``
    is a float or a float32 scalar tensor; on the card the kernel reads a
    tensor through its address, so the call never waits for the card. On
    the card the product runs on the tensor cores, float32 operands split
    into bf16 hi + lo. Returns (best_q f32 [B], best_idx i32 [B])."""
    if seg.device.type == "cpu":
        return sync_search_fused_ref(seg, template, out_len, template_energy)
    name = "sync_search_fused"
    args = _search_launch_args(name, seg, template, out_len)
    b = seg.shape[0]
    dev = seg.device
    n_tiles = -(-(-(-out_len // 128)) // 16)  # blocks of rows of 128 lags: at least 16 rows a block
    part_q = torch.empty(b, n_tiles, dtype=torch.float32, device=dev)
    part_i = torch.empty(b, n_tiles, dtype=torch.int32, device=dev)
    best_q = torch.empty(b, dtype=torch.float32, device=dev)
    best_i = torch.empty(b, dtype=torch.int32, device=dev)
    te, te_val = _energy_operand(name, template_energy, dev)
    err = _entry("sync_search")(
        *args, out_len, _address(te), te_val, part_q.data_ptr(), part_i.data_ptr(),
        best_q.data_ptr(), best_i.data_ptr(), _stream_handle(dev),
    )
    _check_launch(err, name, seg.dtype)
    return best_q, best_i


_SLAB_SOURCES = {"sync_search_fused": "sync_search", "sync_search_blockmax": "search_blockmax",
                 "correlate_fused": "correlate"}
_SLAB_FIELDS = ("blocks_per_sm", "threads", "smem_bytes", "ksl", "slabs", "registers", "local_bytes", "rows")


def search_slab_occupancy(name: str, seg_dtype: torch.dtype, template_dtype: torch.dtype, k: int,
                          out_len: int) -> dict | None:
    """What the card gives the slab kernel of ``name`` (sync_search_fused,
    sync_search_blockmax or correlate_fused) at a launch's geometry:
    {"blocks_per_sm" (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    "threads", "smem_bytes", "ksl" (k-steps a slab), "slabs", "registers"
    and "local_bytes" (spills) a thread, "rows" a block}; None where the
    one-shot route takes the template. Needs the card."""
    import ctypes

    n_steps = -(-(k + 127) // 16)
    w = 8 * n_steps + 72
    w += (16 - w) % 32  # as _search_template_words sizes it
    out = (ctypes.c_int * len(_SLAB_FIELDS))()
    err = _entry(_SLAB_SOURCES[name] + "_slab_occupancy")(
        _KERNEL_DTYPES[seg_dtype], int(template_dtype == torch.float32), w, k, out_len, ctypes.addressof(out))
    if err == 1:  # cudaErrorInvalidValue: the one-shot route's template
        return None
    _check_error(err, f"{name} slab occupancy")
    return dict(zip(_SLAB_FIELDS, out))


# --- demod_at_fused: align + demod at dynamic starts -------------------------


def _span_iq(config: ModemConfig, buffer: torch.Tensor, start: torch.Tensor, n_symbols: int):
    """I/Q float32 [B, S, 2M] of the frames whose preamble starts at
    ``start``: the plain front of the align+demod kernels."""
    from anet_torch.dsp.sync import gather_span

    sps = config.samples_per_symbol
    pre = config.preamble_symbols * sps
    x = gather_span(buffer, start.to(torch.int64) + pre, n_symbols * sps).float()
    basis = _plain_basis(config, buffer.dtype, buffer.device)
    return x.reshape(*x.shape[:-1], n_symbols, sps) @ basis


def demod_at_fused_ref(config: ModemConfig, buffer: torch.Tensor, start: torch.Tensor, n_symbols: int):
    """Plain version of demod_at_fused."""
    return _decisions(config, _span_iq(config, buffer, start, n_symbols), -1)


def demod_at_fused(config: ModemConfig, buffer: torch.Tensor, start: torch.Tensor, n_symbols: int):
    """Timing-align + MFSK symbol decisions straight from the stream buffer:
    (tone i32, best f32, total f32), each [B, n_symbols], for the frames
    whose PREAMBLE starts at ``start[b]`` (data ``preamble_samples``
    later). Samples past the buffer's end read as zero.

    On the card: csrc/demod_at.cu's tensor-core walk, bfloat16 and int8
    buffers against the one-term basis, float32 buffers as the three-term
    bf16 split (within F32_SPLIT_RTOL and F32_SPLIT_ATOL of the plain
    version); off its geometry (sps 4, 8, 16; more than 16 tones) the same
    products on csrc/demod_at_any.cu's runtime-geometry walk
    (_demod_at_operands). ValueError where 128 % sps != 0, as the
    reference."""
    if buffer.device.type == "cpu":
        return demod_at_fused_ref(config, buffer, start, n_symbols)
    return _demod_at_launch(config, buffer, start, n_symbols)


def _demod_at_launch(config: ModemConfig, buffer: torch.Tensor, start: torch.Tensor, n_symbols: int):
    """demod_at_fused's launch: the entry and basis _demod_at_operands
    picks for the config and the buffer's dtype."""
    name = "demod_at_fused"
    dtype, st = _check_buffer_and_starts(name, buffer, start, "start")
    b, length = buffer.shape
    dev = buffer.device
    entry, route, basis = _demod_at_operands(name, "demod_at", config, buffer.dtype, dev)
    tone = torch.empty(b, n_symbols, dtype=torch.int32, device=dev)
    best = torch.empty(b, n_symbols, dtype=torch.float32, device=dev)
    total = torch.empty(b, n_symbols, dtype=torch.float32, device=dev)
    err = _entry(entry)(
        buffer.data_ptr(), dtype, b, length, st.data_ptr(), config.preamble_samples,
        config.samples_per_symbol, n_symbols, config.num_tones, basis.data_ptr(), tone.data_ptr(),
        best.data_ptr(), total.data_ptr(), _stream_handle(dev),
    )
    _check_launch(err, OFF_WALK_KEYS.get(route, name), buffer.dtype)  # off the walk: its route's key
    return tone, best, total


# --- demod_probe_fused: the locked step's merged probe + demod ---------------


def _probe_span_rows(k: int, n_lags: int) -> int:
    return -(-(k + n_lags - 1) // _ROW) + 1


def _probe_template(template: torch.Tensor, dtype: torch.dtype):
    """(float32 taps the probe correlates with, the factor that scales cmax
    back, or None): the template rounded to the buffer's ``dtype``; for an
    int8 buffer quantized to round(t * (127 / max|t|)), scaled back by
    max|t| / 127 (the reference's lines 2368-2380), each division correctly
    rounded, as the reference's."""
    if dtype != torch.int8:
        return template.to(dtype).float(), None
    tf = template.float()
    tmax = tf.abs().amax().clamp_min(1e-20)
    return torch.round(tf * (torch.full_like(tmax, INT8_BASIS_SCALE) / tmax)), tmax / INT8_BASIS_SCALE


# buffer dtype -> {(id, version) of a template: (template, (taps, cmax scale))}
_PROBE_TAPS: dict = {dtype: {} for dtype in _KERNEL_DTYPES}


def _per_template(cache: dict, template: torch.Tensor, make):
    """make(template), made once per template tensor (a stream passes the
    same one every chunk) and again only if it changed in place. The entry
    holds the template, so its id is not reused while cached."""
    key = (id(template), template._version)
    hit = cache.get(key)
    if hit is None or hit[0] is not template:
        if len(cache) >= 8:
            cache.clear()
        hit = cache[key] = (template, make(template))
    return hit[1]


def _cached_probe_template(template: torch.Tensor, dtype: torch.dtype):
    """_probe_template with contiguous taps, made once per template tensor
    and buffer dtype."""

    def make(t):
        taps, scale = _probe_template(t, dtype)
        return taps.contiguous(), scale

    return _per_template(_PROBE_TAPS[dtype], template, make)


def _probe_operands(template: torch.Tensor, dtype: torch.dtype, device):
    """(contiguous float32 taps [k], the cmax scale or None), both on
    ``device``: the probe kernels' template operands for a buffer of
    ``dtype``, made once per template tensor and dtype (a stream passes
    the same template every chunk). For int8 the x127 taps and the float32
    scalar max|t| / 127; the kernel reads the scale through its address and
    multiplies it into cmax itself (no host read, no multiply after the
    launch)."""
    if template.device != device:
        template = template.to(device)
    return _cached_probe_template(template, dtype)


def _probe_abs_corr(buffer: torch.Tensor, st: torch.Tensor, taps: torch.Tensor, n_lags: int):
    """|correlation| float32 [B, n_lags] of the float32 ``taps`` at lags
    st .. st + n_lags - 1: the probes' plain front. Over an int8 buffer the
    integer sums can pass 2**24, so they are taken in float64 (exact) and
    rounded to float32 once, as the reference's int32 sums are."""
    from anet_torch.dsp.sync import gather_span

    k = taps.shape[-1]
    wins = gather_span(buffer, st, k + n_lags - 1).float().unfold(-1, k, 1)
    if buffer.dtype == torch.int8:
        return (wins.double() @ taps.double()).float().abs()
    return (wins @ taps).abs()


def demod_probe_fused_ref(
    config: ModemConfig,
    buffer: torch.Tensor,
    st0: torch.Tensor,
    n_symbols: int,
    template: torch.Tensor,
    *,
    n_lags: int = 5,
):
    """Plain version of demod_probe_fused."""
    from anet_torch.dsp.sync import gather_span

    k = template.shape[-1]
    st = st0.to(torch.int64)
    taps, cmax_scale = _probe_template(template, buffer.dtype)
    cabs = _probe_abs_corr(buffer, st, taps, n_lags)
    span = gather_span(buffer, st // _ROW * _ROW, _probe_span_rows(k, n_lags) * _ROW).float()
    off = torch.argmax(cabs, dim=-1).to(torch.int32)
    tone, best, total = demod_at_fused_ref(config, buffer, st + off, n_symbols)
    cmax = cabs.amax(-1) if cmax_scale is None else cabs.amax(-1) * cmax_scale
    return cmax, off, (span * span).sum(-1), tone, best, total


def demod_probe_fused(
    config: ModemConfig,
    buffer: torch.Tensor,
    st0: torch.Tensor,
    n_symbols: int,
    template: torch.Tensor,
    *,
    n_lags: int = 5,
):
    """Merged frame-lock probe + align+demod.

    Returns (cmax f32 [B], off i32 [B], energy f32 [B], tone, best, total):
    cmax is the maximum raw |correlation| over lags st0 .. st0 + n_lags - 1,
    off its first winning lag, energy the row-aligned superset window
    energy over [128*(st0//128), 128*(st0//128 + ceil((k+n_lags-1)/128) +
    1)) (normalize outside: q = cmax * rsqrt(te * max(energy, 1e-4 te))),
    and the demod triple [B, n_symbols] of the frame starting at
    st0 + off. The template rounds to the buffer's dtype, as the
    reference's does; over an int8 buffer it is quantized to x127 integers
    and cmax scaled back, so the normalization by the float template's
    energy cancels the buffer's scale.

    On the card it is two launches on the current stream: the probe
    (csrc/demod_probe.cu, a warp a stream) writes (cmax, off, energy) and
    the refined starts st0 + off, then demod_at_fused's tensor-core kernel
    (csrc/demod_at.cu; float32 buffers as its three-term bf16 split; off
    its geometry csrc/demod_at_any.cu) runs there. They count as one launch
    of demod_probe_fused, or of its route's key off the walk
    (OFF_WALK_KEYS["at_any"]). ValueError where 128 % sps != 0, as the
    reference."""
    if buffer.device.type == "cpu":
        return demod_probe_fused_ref(config, buffer, st0, n_symbols, template, n_lags=n_lags)
    return _demod_probe_launch(config, buffer, st0, n_symbols, template, n_lags)


def _demod_probe_launch(config: ModemConfig, buffer: torch.Tensor, st0: torch.Tensor, n_symbols: int,
                        template: torch.Tensor, n_lags: int):
    """demod_probe_fused's two launches: csrc/demod_probe.cu's probe, then
    the decisions entry _demod_at_operands picks at the refined starts; one
    count, on that entry's route."""
    name = "demod_probe_fused"
    dtype, st = _check_buffer_and_starts(name, buffer, st0, "st0")
    if not 1 <= n_lags <= 8:
        raise ValueError(f"{name}: n_lags must be in [1, 8]")
    b, length = buffer.shape
    dev = buffer.device
    entry, route, basis = _demod_at_operands(name, "demod_at", config, buffer.dtype, dev)
    k = template.shape[-1]
    cmax = torch.empty(b, dtype=torch.float32, device=dev)
    off = torch.empty(b, dtype=torch.int32, device=dev)
    energy = torch.empty(b, dtype=torch.float32, device=dev)
    tone = torch.empty(b, n_symbols, dtype=torch.int32, device=dev)
    best = torch.empty(b, n_symbols, dtype=torch.float32, device=dev)
    total = torch.empty(b, n_symbols, dtype=torch.float32, device=dev)
    if b == 0:
        return cmax, off, energy, tone, best, total
    taps, cmax_scale = _probe_operands(template, buffer.dtype, dev)
    start = torch.empty(b, dtype=torch.int32, device=dev)  # st0 + off, where the demod runs
    stream = _stream_handle(dev)
    err = _entry("demod_probe")(
        buffer.data_ptr(), dtype, b, length, st.data_ptr(), taps.data_ptr(), k, n_lags,
        _probe_span_rows(k, n_lags), None if cmax_scale is None else cmax_scale.data_ptr(),
        cmax.data_ptr(), off.data_ptr(), energy.data_ptr(), start.data_ptr(), stream,
    )
    _check_error(err, f"{name} (probe)")
    err = _entry(entry)(
        buffer.data_ptr(), dtype, b, length, start.data_ptr(), config.preamble_samples,
        config.samples_per_symbol, n_symbols, config.num_tones, basis.data_ptr(), tone.data_ptr(),
        best.data_ptr(), total.data_ptr(), stream,
    )
    _check_error(err, f"{name} (demod)")
    _count_launch(name, buffer.dtype, route)  # one launch of the function: its two kernels
    return cmax, off, energy, tone, best, total


# --- viterbi_trellis: the coded receiver's 64-state soft Viterbi --------------

VIT_STATES = 64  # 2**(K-1), K = 7
VIT_BIG = 1e9  # start metric of every state but state 0


def viterbi_trellis_ref(signs: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """Plain version of viterbi_trellis: a loop over the trellis steps on
    [64, N] path metrics, then the traceback from state 0. Candidate j of
    state ns is pm[(ns >> 1) | (j << 5)] + signs[ns, 2j] * rx0 +
    signs[ns, 2j+1] * rx1, added in that order; j = 1 wins only if strictly
    smaller; metrics start at 0 for state 0 and 1e9 elsewhere and are never
    normalized."""
    n, t_steps, _ = rx.shape
    dev = rx.device
    ns = torch.arange(VIT_STATES, device=dev)
    idx0, idx1 = ns >> 1, (ns >> 1) | (VIT_STATES >> 1)
    sg = signs.float()
    s00, s01, s10, s11 = (sg[:, c : c + 1] for c in range(4))
    rx_tm = rx.float().permute(1, 2, 0)  # [T, 2, N]
    pm = torch.full((VIT_STATES, n), VIT_BIG, dtype=torch.float32, device=dev)
    pm[0] = 0.0
    takes = torch.empty(t_steps, VIT_STATES, n, dtype=torch.bool, device=dev)
    for t in range(t_steps):
        rx0, rx1 = rx_tm[t, 0:1], rx_tm[t, 1:2]
        cand0 = pm[idx0] + s00 * rx0 + s01 * rx1
        cand1 = pm[idx1] + s10 * rx0 + s11 * rx1
        torch.lt(cand1, cand0, out=takes[t])  # ties -> j = 0
        pm = torch.minimum(cand0, cand1)
    state = torch.zeros(1, n, dtype=torch.int64, device=dev)  # tail-flushed: end in state 0
    bits = torch.empty(n, t_steps, dtype=torch.uint8, device=dev)
    for t in range(t_steps - 1, -1, -1):
        bits[:, t] = (state[0] & 1).to(torch.uint8)
        j = takes[t].gather(0, state).to(torch.int64)
        state = (state >> 1) | (j << 5)
    return bits


def viterbi_trellis(signs: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """Forward add-compare-select and traceback over the 64-state rate-1/2
    K=7 trellis, one stream per row.

    ``signs`` is float32 [64, 4]: per state the +-1 branch-metric signs
    (minus the expected coded pair of its j=0, then its j=1 transition).
    ``rx`` is float32 [N, T, 2]: per trellis step the signed soft pair
    (+ = bit 1), batch-major, as bit_llrs and deinterleave leave it.
    Returns uint8 [N, T], the decided input bits (data + tail). The search
    starts in state 0 and traces back from state 0."""
    if rx.device.type == "cpu":
        return viterbi_trellis_ref(signs, rx)
    name = "viterbi_trellis"
    if not rx.is_cuda:
        raise ValueError(f"{name}: rx must be a CUDA tensor, got {rx.device}")
    if rx.dtype != torch.float32 or rx.dim() != 3 or rx.shape[-1] != 2 or not rx.is_contiguous():
        raise ValueError(f"{name}: rx must be a contiguous float32 [N, T, 2] tensor")
    if signs.shape != (VIT_STATES, 4):
        raise ValueError(f"{name}: signs must be [64, 4], got {tuple(signs.shape)}")
    n, t_steps, _ = rx.shape
    dev = rx.device
    sg = signs.to(device=dev, dtype=torch.float32).contiguous()
    if rx.data_ptr() % 8:  # the kernel loads a step's pair as one float2
        rx = rx.clone()
    if sg.data_ptr() % 16:  # and a state's four signs as one float4
        sg = sg.clone()
    bits = torch.empty(n, t_steps, dtype=torch.uint8, device=dev)
    # the decision words, per 32 steps word s the decisions of state s
    dec = torch.empty(n, -(-t_steps // 32), 32, 2, dtype=torch.int32, device=dev)
    err = _entry("viterbi")(
        sg.data_ptr(), rx.data_ptr(), n, t_steps, dec.data_ptr(), bits.data_ptr(), _stream_handle(dev)
    )
    _check_launch(err, name)
    return bits


# --- demod_at_energies_fused: align + demod, every tone's energy --------------


def demod_at_energies_fused_ref(
    config: ModemConfig, buffer: torch.Tensor, start: torch.Tensor, n_symbols: int
) -> torch.Tensor:
    """Plain version of demod_at_energies_fused."""
    m = config.num_tones
    iq = _span_iq(config, buffer, start, n_symbols)
    i, q = iq[..., :m], iq[..., m:]
    return i * i + q * q


def demod_at_energies_fused(
    config: ModemConfig, buffer: torch.Tensor, start: torch.Tensor, n_symbols: int
) -> torch.Tensor:
    """Timing-align + the full tone-energy filterbank straight from the
    stream buffer: float32 [B, n_symbols, num_tones], the energies twin of
    demod_at_fused for consumers that need every tone's energy (soft FEC
    LLRs). The frame's PREAMBLE starts at ``start[b]``; samples past the
    buffer's end read as zero.

    On the card: csrc/demod_at_energies.cu's tensor-core walk, bfloat16 and
    int8 buffers against the one-term basis, float32 buffers as the
    three-term bf16 split (each energy within F32_SPLIT_RTOL of itself plus
    F32_SPLIT_ATOL of its symbol's largest plain energy); off its geometry
    the same products on csrc/demod_at_any.cu (_demod_at_operands).
    ValueError where 128 % sps != 0, as the reference."""
    if buffer.device.type == "cpu":
        return demod_at_energies_fused_ref(config, buffer, start, n_symbols)
    return _demod_at_energies_launch(config, buffer, start, n_symbols)


def _demod_at_energies_launch(config: ModemConfig, buffer: torch.Tensor, start: torch.Tensor, n_symbols: int):
    """demod_at_energies_fused's launch: the entry and basis
    _demod_at_operands picks for the config and the buffer's dtype."""
    name = "demod_at_energies_fused"
    dtype, st = _check_buffer_and_starts(name, buffer, start, "start")
    b, length = buffer.shape
    dev = buffer.device
    entry, route, basis = _demod_at_operands(name, "demod_at_energies", config, buffer.dtype, dev)
    energies = torch.empty(b, n_symbols, config.num_tones, dtype=torch.float32, device=dev)
    err = _entry(entry)(
        buffer.data_ptr(), dtype, b, length, st.data_ptr(), config.preamble_samples,
        config.samples_per_symbol, n_symbols, config.num_tones, basis.data_ptr(),
        energies.data_ptr(), _stream_handle(dev),
    )
    _check_launch(err, OFF_WALK_KEYS.get(route, name), buffer.dtype)  # off the walk: its route's key
    return energies


# --- probe_at_fused: the unmerged lock step's probe ---------------------------


def probe_at_fused_ref(
    buffer: torch.Tensor, st0: torch.Tensor, template: torch.Tensor, template_energy,
    n_lags: int = 5,
) -> torch.Tensor:
    """Plain version of probe_at_fused."""
    from anet_torch.dsp.sync import gather_span

    k = template.shape[-1]
    st = st0.to(torch.int64)
    cabs = _probe_abs_corr(buffer, st, template.to(buffer.dtype).float(), n_lags)
    span = gather_span(buffer, st, _probe_span_rows(k, n_lags) * _ROW).float()
    energy = (span * span).sum(-1, keepdim=True)
    te = torch.as_tensor(template_energy, dtype=torch.float32, device=buffer.device)
    return cabs * torch.rsqrt(te * torch.maximum(energy, 1e-4 * te))


def probe_at_fused(
    buffer: torch.Tensor, st0: torch.Tensor, template: torch.Tensor, template_energy,
    n_lags: int = 5,
) -> torch.Tensor:
    """Frame-lock verify/refine probe: normalized preamble quality, float32
    [B, n_lags], at the ``n_lags`` lags st0 .. st0 + n_lags - 1 of each
    stream (st0 already clipped by the caller):

        q[o] = |corr[o]| * rsqrt(te * max(energy, 1e-4 * te))

    with one window energy per stream over the st0-ALIGNED superset span
    [st0, st0 + 128 * (ceil((k + n_lags - 1) / 128) + 1)): a superset of
    every probed window, so quality only under-reports. (The row-aligned
    span of sync.preamble_quality_probe differs from it by a few percent.)
    Samples past the buffer's end read as zero; the template rounds to the
    buffer's dtype. ``template_energy`` (te) is a float or a float32 scalar
    tensor; on the card the kernel reads a tensor through its address, so
    the call never waits for the card.

    On the card: csrc/demod_probe.cu's probe_at_kernel, a warp a stream
    (demod_probe_fused's staged probe with the span at st0), float32 or
    bfloat16 buffers."""
    if buffer.device.type == "cpu":
        return probe_at_fused_ref(buffer, st0, template, template_energy, n_lags)
    return _probe_at_launch(buffer, st0, template, template_energy, n_lags)


def _probe_at_launch(buffer, st0, template, template_energy, n_lags):
    """probe_at_fused's launch: the taps made once per template tensor,
    ``template_energy`` as _energy_operand passes it."""
    name = "probe_at_fused"
    dtype, st = _check_buffer_and_starts(name, buffer, st0, "st0", int8=False)
    if not 1 <= n_lags <= 8:
        raise ValueError(f"{name}: n_lags must be in [1, 8]")
    b, length = buffer.shape
    dev = buffer.device
    k = template.shape[-1]
    q = torch.empty(b, n_lags, dtype=torch.float32, device=dev)
    if b == 0:
        return q
    taps, _ = _probe_operands(template, buffer.dtype, dev)
    te, te_val = _energy_operand(name, template_energy, dev)
    err = _entry("probe_at")(
        buffer.data_ptr(), dtype, b, length, st.data_ptr(), taps.data_ptr(), k, n_lags,
        _probe_span_rows(k, n_lags), _address(te), te_val, q.data_ptr(), _stream_handle(dev),
    )
    _check_launch(err, name)
    return q


# --- correlate_fused: every lag of the preamble correlation -------------------


def correlate_fused_ref(seg: torch.Tensor, template: torch.Tensor, out_len: int) -> torch.Tensor:
    """Plain version of correlate_fused: the block-Toeplitz product of
    anet_torch.dsp.sync.correlate_template, the segment zero-padded where it
    is shorter than out_len + k - 1."""
    from anet_torch.dsp.sync import correlate_template

    k = template.shape[-1]
    seg_f = seg.float()
    short = out_len + k - 1 - seg_f.shape[-1]
    if short > 0:
        seg_f = torch.nn.functional.pad(seg_f, (0, short))
    return correlate_template(seg_f, template.float(), method="matmul")[..., :out_len]


def correlate_fused(seg: torch.Tensor, template: torch.Tensor, out_len: int) -> torch.Tensor:
    """Valid-mode correlation [B, N] x [k] -> float32 [B, out_len] with every
    lag written out: out[b, l] = sum_j seg[b, l + j] * template[j], float32
    accumulation whatever the input dtype. ``out_len <= N - k + 1`` is the
    callers' contract; samples past the end of ``seg`` read as zero. Rows of
    ``seg`` may be strided (a view into the stream buffer) as long as the
    last dimension is contiguous. The multi-candidate variable-length stream
    step reads the whole array (stream._slide_and_quality). On the card the
    product runs on the search kernels' tensor-core core, a float32 segment
    or template split into bf16 hi + lo (three products for float32 x
    float32: 2^-16 of each product's size)."""
    if seg.device.type == "cpu":
        return correlate_fused_ref(seg, template, out_len)
    name = "correlate_fused"
    dtype = _check_cuda_input(name, seg, "seg")
    if seg.dim() != 2 or out_len < 1:
        raise ValueError(f"{name}: seg must be [B, N] and out_len positive")
    if template.dim() != 1:
        raise ValueError(f"{name}: template must be [k]")
    b = seg.shape[0]
    dev = seg.device
    if template.dtype not in (torch.float32, torch.bfloat16):
        template = template.float()
    words = _per_template(_SEARCH_WORDS, template.to(dev), _search_template_words)
    out = torch.empty(b, out_len, dtype=torch.float32, device=dev)
    err = _entry("correlate")(
        seg.data_ptr(), dtype, b, seg.stride(0), seg.shape[-1], words.data_ptr(),
        int(words.shape[0] == 2), words.shape[-1], template.shape[-1], out_len, out.data_ptr(),
        _stream_handle(dev),
    )
    _check_launch(err, name, seg.dtype)
    return out


# --- decide_tones_tm: time-major decisions without the frame parse ------------


def decide_tones_tm_ref(config: ModemConfig, data_tm: torch.Tensor):
    """Plain version of decide_tones_tm."""
    sps = config.samples_per_symbol
    t, b = data_tm.shape
    s = t // sps
    w = data_tm[: s * sps].float().reshape(s, sps, b)
    basis_t = demod_basis(config, dtype=data_tm.dtype, device=data_tm.device).float().T
    return _decisions(config, torch.einsum("mk,skb->smb", basis_t, w), 1)


def decide_tones_tm(config: ModemConfig, data_tm: torch.Tensor):
    """Time-major fused symbol decision: ``data_tm`` [T, B] (float32 or
    bfloat16) is a symbol-aligned data section with time leading and the
    stream batch minor. Returns (tone int32, best float32, total float32),
    each [T // sps, B]; a trailing partial symbol is dropped and argmax ties
    go to the first tone. No parse: every symbol present is decided, so the
    quality means that follow cover the whole window (decide_frame_tm
    covers exactly the frame's own symbols).

    Any samples_per_symbol and tone count. On the card (the route:
    _tm_operands) sps 32, 48, 64, 80 and 128 with at most 32 tones
    (_filterbank_tensor_core_geometry: every MFSK preset) take
    decide_frame_tm's tensor-core walk (csrc/decide_frame_tm.cu, its
    decisions epilogue; 17-32 tones with the basis in shared memory) with
    the basis of _demod_at_basis: bfloat16 data one product, float32 data
    the three-term bf16 split (within F32_SPLIT_RTOL and F32_SPLIT_ATOL);
    every other geometry (sps 24, 40, 96, 160 or 1,920, more than 32
    tones) csrc/frame_tm_any.cu, the same products with the geometry known
    at run time (bfloat16 one product; float32 the split)."""
    if data_tm.device.type == "cpu":
        return decide_tones_tm_ref(config, data_tm)
    return _decide_tones_tm_launch(config, data_tm)


def _decide_tones_tm_launch(config: ModemConfig, data_tm: torch.Tensor):
    name = "decide_tones_tm"
    dtype = _check_cuda_input(name, data_tm, "data_tm")
    if data_tm.dim() != 2 or not data_tm.is_contiguous():
        raise ValueError(f"{name}: data_tm must be a contiguous [T, B] tensor")
    t, b = data_tm.shape
    sps = config.samples_per_symbol
    s = t // sps
    if s < 1 or b < 1:
        raise ValueError(f"{name}: data_tm {tuple(data_tm.shape)} holds no whole symbol")
    dev = data_tm.device
    tone = torch.empty(s, b, dtype=torch.int32, device=dev)
    best = torch.empty(s, b, dtype=torch.float32, device=dev)
    total = torch.empty(s, b, dtype=torch.float32, device=dev)
    entry, route, basis = _tm_operands(name, config, data_tm.dtype, dev)
    err = _entry(entry)(
        data_tm.data_ptr(), dtype, b, sps, config.num_tones, s, basis.data_ptr(),
        tone.data_ptr(), best.data_ptr(), total.data_ptr(), _stream_handle(dev),
    )
    _check_launch(err, name, data_tm.dtype, route)
    return tone, best, total


# --- gather_rows_fused: the timing-alignment gather ---------------------------


def gather_rows_fused_ref(buffer: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """Plain version of gather_rows_fused (sync.gather_span: zeros outside
    the buffer)."""
    from anet_torch.dsp.sync import gather_span

    return gather_span(buffer, start, size)


def gather_rows_fused(buffer: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """out[..., i] = buffer[..., start[...] + i], in the buffer's dtype
    [..., size]: sync.aligned_gather's contract as one kernel. Pure data
    movement, bit-exact in any dtype of 1, 2 or 4 bytes (int8, bfloat16,
    float16, float32, ...). Callers guarantee 0 <= start and start + size
    <= buffer length; positions outside the buffer read as zero (the
    reference reads its zero padding there)."""
    if buffer.device.type == "cpu":
        return gather_rows_fused_ref(buffer, start, size)
    return _gather_rows_launch(buffer, start, size)


def _gather_rows_launch(buffer: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    name = "gather_rows_fused"
    _check_on_card(name, buffer, "buffer")
    if buffer.element_size() not in (1, 2, 4):  # the kernel moves 1-, 2- or 4-byte elements
        raise TypeError(f"{name}: buffer must have 1-, 2- or 4-byte elements, got {buffer.dtype}")
    if buffer.dim() < 2 or not buffer.is_contiguous():
        raise ValueError(f"{name}: buffer must be a contiguous [..., L] tensor with a batch")
    if start.shape != buffer.shape[:-1]:
        raise ValueError(
            f"{name}: start must be {tuple(buffer.shape[:-1])}, got {tuple(start.shape)}"
        )
    if size < 1 or buffer.numel() == 0:
        raise ValueError(f"{name}: nothing to gather (size {size}, buffer {tuple(buffer.shape)})")
    dev = buffer.device
    length = buffer.shape[-1]
    st = start.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
    out = torch.empty(*buffer.shape[:-1], size, dtype=buffer.dtype, device=dev)
    err = _entry("gather_rows")(
        buffer.data_ptr(), buffer.element_size(), st.shape[0], length, st.data_ptr(), size,
        out.data_ptr(), _stream_handle(dev),
    )
    _check_launch(err, name, buffer.dtype)
    return out


# --- ofdm_track_decide_fused: the OFDM equalizer's back half -----------------

_QPSK_AMP = 0.7071067811865476  # 1/sqrt(2), unit average symbol power
_QAM16_SCALE = 0.31622776601683794  # 1/sqrt(10)
_QAM64_SCALE = 0.1543033499620919  # 1/sqrt(42)


def _ideal_axis(a: torch.Tensor, bpc: int) -> torch.Tensor:
    """Per-axis constellation point implied by the LLR signs, strict
    boundaries included, so the error power equals that of
    bits_to_carriers(llrs > 0)."""
    if bpc == 2:
        return torch.where(a < 0, -_QPSK_AMP, _QPSK_AMP).float()
    sign = torch.where(a > 0, 1.0, -1.0).float()
    mag_a = a.abs()
    if bpc == 4:
        return sign * torch.where(mag_a < 2.0 * _QAM16_SCALE, 1.0, 3.0).float() * _QAM16_SCALE
    s = _QAM64_SCALE
    mag = torch.where(
        mag_a <= 2.0 * s, 1.0,
        torch.where(mag_a < 4.0 * s, 3.0, torch.where(mag_a < 6.0 * s, 5.0, 7.0)),
    ).float()
    return sign * mag * s


def _llr_axis(a: torch.Tensor, w: torch.Tensor, bpc: int) -> tuple:
    """Max-log LLR planes of one axis; QPSK's is -a w (the unnormalized
    matched-filter output)."""
    from anet_torch.dsp import ofdm

    if bpc == 2:
        return (-(a * w),)
    if bpc == 4:
        return ofdm._pam4_llrs(a, w)
    return ofdm._pam8_llrs(a, w)


def ofdm_track_decide_fused_ref(
    config, z_eq: torch.Tensor, h_pow: torch.Tensor, slope0: torch.Tensor, *,
    evm_symbols: int | None = None, with_coherence: bool = False,
):
    """Plain version of ofdm_track_decide_fused: ofdm._phase_track (two fit
    iterations and the identity gate), the derotation, the LLR planes and
    the error power."""
    from anet_torch.dsp import ofdm

    s, c = z_eq.shape[-2:]
    bpc = config.bits_per_carrier
    evm_rows = s if evm_symbols is None else evm_symbols
    w = h_pow.float()[..., None, :]
    coh = torch.zeros(*z_eq.shape[:-2], 2, dtype=torch.float32, device=z_eq.device)
    if config.clock_tracking:
        rot, coh = ofdm._phase_track(config, z_eq, w, slope0, with_coherence=True)
        z_eq = z_eq * rot
    zr, zi = z_eq.real, z_eq.imag
    planes = _llr_axis(zr, w, bpc) + _llr_axis(zi, w, bpc)
    llrs = torch.stack(planes, dim=-1).reshape(*z_eq.shape[:-2], s * c * bpc)
    er = (zr - _ideal_axis(zr, bpc))[..., :evm_rows, :]
    ei = (zi - _ideal_axis(zi, bpc))[..., :evm_rows, :]
    evm2 = (er * er + ei * ei).sum((-2, -1)) / (evm_rows * c)
    return (llrs, evm2, coh) if with_coherence else (llrs, evm2)


def ofdm_track_decide_fused(
    config, z_eq: torch.Tensor, h_pow: torch.Tensor, slope0: torch.Tensor, *,
    evm_symbols: int | None = None, with_coherence: bool = False,
):
    """The OFDM equalizer's back half, a warp per stream on short frames and
    a block of warps per stream on long ones (_ofdm_track_route): the
    decision-directed clock fit (two iterations from the preamble seed
    ``slope0``; skipped when config.clock_tracking is off), the identity
    gate, the derotation, the max-log LLR planes and the error-vector power.

    ``z_eq`` is complex64 [..., S, C] (any strides; a time-major [S, C, B]
    tensor passes as its [B, S, C] view), ``h_pow`` float32 [..., C] (any
    strides) the per-carrier channel power, ``slope0`` float32 [...].
    Returns (llrs float32 [..., S*C*bpc] in the interleaved layout of the
    reference's _equalized_bits, evm2 float32 [...] over the first
    ``evm_symbols`` symbols, default all); with ``with_coherence`` also the
    gate's coherences float32 [..., 2] (tracked, unrotated; zeros without
    tracking)."""
    if z_eq.device.type == "cpu":
        return ofdm_track_decide_fused_ref(
            config, z_eq, h_pow, slope0, evm_symbols=evm_symbols, with_coherence=with_coherence
        )
    if not z_eq.is_cuda:
        raise ValueError(f"ofdm_track_decide_fused: z_eq must be a CUDA tensor, got {z_eq.device}")
    return _ofdm_track_launch(config, z_eq, h_pow, slope0, evm_symbols, with_coherence)


OFDM_STAGE_BYTES = 232_448  # shared memory a block can opt in to (csrc/ofdm_track.cu MAX_SMEM)
OFDM_SM_BYTES = 233_472  # shared memory an SM holds, each block's 1,024 reserved bytes included
# The fewest warps an SM at which the staged route keeps a stream: one
# boundary for both layouts, whose bits agree only on one route, where the
# route picked loses least to the other in either layout and batch
# (time_search --kernels ofdm; PERF.md)
OFDM_STAGED_MIN_WARPS = 8


def _ofdm_staged_warps(s: int, c: int) -> int:
    """Warps an SM of the staged route on S symbols of C carriers: its block
    of 4 streams, halved until one stream's points and weights fit in
    OFDM_STAGE_BYTES (csrc/ofdm_track.cu's launch_staged and stream_bytes),
    and as many blocks as an SM's shared memory holds; 0 where a stream does
    not fit at all."""
    per = (s * c * 8 + c * 4 + 15) // 16 * 16
    nw = 4
    while nw > 1 and nw * per > OFDM_STAGE_BYTES:
        nw //= 2
    if nw * per > OFDM_STAGE_BYTES:
        return 0
    return nw * min(OFDM_SM_BYTES // (nw * per + 1024), 32, 64 // nw)


def _ofdm_track_route(s: int, c: int) -> str:
    """The route of an ofdm_track_decide_fused launch on S symbols of C
    carriers, from the shapes alone, the same in both layouts (whose bits
    agree only on one route): "staged" (entry ofdm_track, a warp a stream
    over its points in shared memory) wherever that keeps at least
    OFDM_STAGED_MIN_WARPS warps an SM (_ofdm_staged_warps: S <= 37 at C =
    96), else "block" (entry ofdm_track_block, a block of warps a stream,
    32 warps an SM at any S, counted under "ofdm_track_decide_fused:block")."""
    return "staged" if _ofdm_staged_warps(s, c) >= OFDM_STAGED_MIN_WARPS else "block"


def _ofdm_track_launch(config, z_eq, h_pow, slope0, evm_symbols, with_coherence):
    """ofdm_track_decide_fused's launch on the route _ofdm_track_route
    picks: z_eq and h_pow go to the kernel by their strides (in complex and
    float elements), views left as they are."""
    name = "ofdm_track_decide_fused"
    if z_eq.dtype != torch.complex64 or z_eq.dim() < 2:
        raise ValueError(f"{name}: z_eq must be a complex64 [..., S, C] tensor")
    lead, (s, c) = z_eq.shape[:-2], z_eq.shape[-2:]
    if c != config.n_carriers or h_pow.shape != (*lead, c) or slope0.shape != lead:
        raise ValueError(
            f"{name}: need h_pow [..., {config.n_carriers}] and slope0 [...] for z_eq "
            f"{tuple(z_eq.shape)}, got {tuple(h_pow.shape)} and {tuple(slope0.shape)}"
        )
    if h_pow.dtype != torch.float32 or h_pow.device != z_eq.device:
        raise ValueError(f"{name}: h_pow must be float32 on {z_eq.device}")
    evm_rows = s if evm_symbols is None else evm_symbols
    if not 1 <= evm_rows <= s:
        raise ValueError(f"{name}: evm_symbols must be in [1, {s}], got {evm_rows}")
    dev = z_eq.device
    z3 = torch.view_as_real(z_eq.reshape(-1, s, c))  # interleaved float2, a view where it can be
    hp = h_pow.reshape(-1, c)
    b = z3.shape[0]
    sl = slope0.to(dtype=torch.float32).reshape(b).contiguous()
    bpc = config.bits_per_carrier
    llrs = torch.empty(*lead, s * c * bpc, dtype=torch.float32, device=dev)
    evm2 = torch.empty(lead, dtype=torch.float32, device=dev)
    coh = torch.zeros(*lead, 2, dtype=torch.float32, device=dev) if with_coherence else None
    route = _ofdm_track_route(s, c)
    err = _entry("ofdm_track" if route == "staged" else "ofdm_track_block")(
        z3.data_ptr(), *(st // 2 for st in z3.stride()[:3]), hp.data_ptr(), *hp.stride(),
        sl.data_ptr(), b, s, c, bpc, config.first_carrier, int(config.clock_tracking), evm_rows,
        llrs.data_ptr(), evm2.data_ptr(), None if coh is None else coh.data_ptr(),
        _stream_handle(dev),
    )
    _check_launch(err, name if route == "staged" else f"{name}:block")
    return (llrs, evm2, coh) if with_coherence else (llrs, evm2)


# --- tone_energies_fused / decide_tones_fused: the batch-major filterbank -----


def _filterbank_operands(kind: str, config: ModemConfig, compute_dtype,
                         device) -> tuple[str, str, torch.Tensor]:
    """(entry point, route, basis) of a filterbank launch, ``kind``
    "tone_energies" or "decide_tones". The route follows the compute dtype
    and the geometry, never the rows' dtype; every route runs on the tensor
    cores. At the geometry of _filterbank_tensor_core_geometry (sps 32, 48,
    64, 80 or 128, at most 32 tones), tone_energies.cu's compile-time walk:
    bfloat16 compute the entry ``kind + "_mma"`` (route "mma") with
    _demod_mma_basis, float32 compute the entry ``kind + "_mma_f32"``
    (route "split") with the three-term _demod_split_basis, on bfloat16 or
    float32 rows alike. Any other geometry, filterbank_any.cu's walk with
    the geometry known at run time and _filterbank_any_basis: bfloat16
    compute the entry ``kind + "_any"`` (route "any"), float32 compute
    ``kind + "_any_f32"`` (route "any_split"), both counted under
    OFF_WALK_KEYS["any"]."""
    fast = _filterbank_tensor_core_geometry(config)
    if fast and compute_dtype == torch.bfloat16:
        return f"{kind}_mma", "mma", _demod_mma_basis(config, torch.bfloat16, device)
    if fast:
        return f"{kind}_mma_f32", "split", _demod_split_basis(config, device)
    if compute_dtype == torch.bfloat16:
        return f"{kind}_any", "any", _filterbank_any_basis(config, torch.bfloat16, device)
    return f"{kind}_any_f32", "any_split", _filterbank_any_basis(config, torch.float32, device)


FILTERBANK_GROUP = 32  # tones a group of csrc/filterbank_any.cu and frame_tm_any.cu: 8 n8 tiles


@functools.lru_cache(maxsize=16)
def _filterbank_any_basis(config: ModemConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The B operand of the runtime-geometry walks (csrc/filterbank_any.cu,
    csrc/frame_tm_any.cu) for ``dtype`` compute, a flat int32 tensor. The
    [sps, 2M] basis _plain_basis(config, dtype) in groups of G = min(M,
    FILTERBANK_GROUP) tones, each group the [E KS, 8 n] product columns of
    _mma_fragments (column 2c the cos of the group's tone c, 2c + 1 its sin,
    zero columns past G; n = _demod_mma_tiles(G)) over KS = ceil(sps / E)
    k-steps of E = 16 samples (32 for int8), zero rows past sps. bfloat16:
    the bf16 entries as words [group, k-step, n-tile, lane, register], word
    (lane 4 g + i, register r) the bf16 pair at rows 16 k-step + 8 r + 2 i
    + (0, 1) of column 8 n-tile + g, the first in the low half (a lane's
    two words one 8-byte vector). int8 (frame_tm_any.cu's int8 frames): the
    x127 integers in the same words, word (lane 4 g + i, register r) the 4
    bytes at rows 32 k-step + 16 r + 4 i + (0..3), the first in the low
    byte. float32: the three bf16 terms of the float32 entries
    (_split_terms), b0 in the bfloat16 layout, then b1 and b2 as words
    [group, k-step, n-tile, lane, term, register] (a lane's four words one
    16-byte vector)."""
    m, sps = config.num_tones, config.samples_per_symbol
    gm = min(m, FILTERBANK_GROUP)
    e = 32 if dtype == torch.int8 else 16
    ng, nt, ks = m // gm, _demod_mma_tiles(gm), -(-sps // e)
    plain = _plain_basis(config, dtype, device)  # [sps, 2M]
    cols = torch.zeros(e * ks, ng, 8 * nt, dtype=torch.float32, device=device)
    cols[:sps, :, 0 : 2 * gm : 2] = plain[:, :m].reshape(sps, ng, gm)
    cols[:sps, :, 1 : 2 * gm : 2] = plain[:, m:].reshape(sps, ng, gm)
    return _any_words(cols, dtype)


def _any_words(cols: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The product columns ``cols`` [E ks, ng, 8 nt] (E = 32 samples a
    k-step for int8, else 16; ng groups of nt n-tiles) as the flat int32 B
    operand of the runtime-geometry walks, in the layout
    _filterbank_any_basis states: words [group, k-step, n-tile, lane,
    register] of the bf16 (int8) entries; for float32 the three bf16 terms
    (_split_terms), b0 so, then b1 and b2 as words [group, k-step, n-tile,
    lane, term, register]."""
    e = 32 if dtype == torch.int8 else 16
    ks, ng, nt = cols.shape[0] // e, cols.shape[1], cols.shape[2] // 8

    def words(t: torch.Tensor, kind: torch.dtype = torch.bfloat16) -> torch.Tensor:
        # [e ks, ng, 8 nt] of bf16 (int8) values -> int32 [ng, ks, nt, 32, 2]
        v = t.to(kind).reshape(ks, 2, 4, e // 8, ng, nt, 8)  # [s, r, i, byte or half, group, t, g]
        v = v.permute(4, 0, 5, 6, 2, 1, 3).contiguous()  # [group, s, t, g, i, r, e]
        return v.view(torch.int32).reshape(ng, ks, nt, 32, 2)

    if dtype != torch.float32:
        return words(cols, dtype).flatten()
    b0, b1, b2 = (words(t) for t in _split_terms(cols))
    return torch.cat([b0.flatten(), torch.stack([b1, b2], dim=-2).flatten()])


def _demod_at_any_geometry(config: ModemConfig, dtype: torch.dtype) -> tuple[int, int, int, int, int]:
    """(r, ks, gm, ng, nt) of csrc/demod_at_any.cu for a buffer of
    ``dtype``: r = max(1, E / sps) symbols an A row of E = 16 samples a
    k-step (32 for int8), ks = r sps / E k-steps a row, gm tones a group
    (all M of a row of r > 1 symbols, else min(M, FILTERBANK_GROUP)), ng =
    M / gm groups and nt n-tiles a group, the r 2 gm columns' (r > 1: at
    most 8 n-tiles, which every modem below Nyquist keeps, 2M <= sps)."""
    m, sps = config.num_tones, config.samples_per_symbol
    e = 32 if dtype == torch.int8 else 16
    r = max(1, e // sps)
    gm = m if r > 1 else min(m, FILTERBANK_GROUP)
    cols = r * 2 * gm
    if cols > 64:
        raise ValueError(f"demod_at_any: {m} tones at samples_per_symbol {sps} pass 8 n-tiles a row")
    return r, r * sps // e, gm, m // gm, 1 if cols <= 8 else 2 if cols <= 16 else 4 if cols <= 32 else 8


@functools.lru_cache(maxsize=16)
def _demod_at_any_basis(config: ModemConfig, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The B operand of csrc/demod_at_any.cu (the align+demod kernels off
    their compile-time walk) for a buffer of ``dtype``, a flat int32
    tensor in _any_words' layout (float32: the three-term split). The
    reference's layout (_demod_at_setup lines 1895-1906) cut to a k-step:
    an A row is r = max(1, E / sps) symbols (_demod_at_any_geometry), and
    slot u of the row, its symbol u, meets rows u sps .. (u + 1) sps - 1
    of the [r sps, ...] columns alone: column u 2 gm + 2 c is the cos of
    tone c of _plain_basis's entries, u 2 gm + 2 c + 1 its sin (a
    block-diagonal basis, r 2M columns). A row of one symbol (sps >= E)
    takes its M tones in groups of gm (32 past 32 tones), as
    _filterbank_any_basis's. Zero columns past the slots'."""
    m, sps = config.num_tones, config.samples_per_symbol
    r, ks, gm, ng, nt = _demod_at_any_geometry(config, dtype)
    e = 32 if dtype == torch.int8 else 16
    plain = _plain_basis(config, dtype, device)  # [sps, 2M]
    cos, sin = plain[:, :m].reshape(sps, ng, gm), plain[:, m:].reshape(sps, ng, gm)
    cols = torch.zeros(e * ks, ng, 8 * nt, dtype=torch.float32, device=device)
    for u in range(r):
        rows = slice(u * sps, (u + 1) * sps)
        cols[rows, :, u * 2 * gm : (u + 1) * 2 * gm : 2] = cos
        cols[rows, :, u * 2 * gm + 1 : (u + 1) * 2 * gm : 2] = sin
    return _any_words(cols, dtype)


_AT_ANY_FIELDS = ("blocks_per_sm", "threads", "smem_bytes", "registers", "local_bytes", "ks", "nt", "mt")


def demod_at_any_occupancy(config: ModemConfig, dtype: torch.dtype, n_symbols: int, decide: bool = True) -> dict:
    """What the card gives csrc/demod_at_any.cu's instantiation for a
    buffer of ``dtype`` at the config's geometry and ``n_symbols`` (the
    decisions' kernel, or the energies' where not ``decide``):
    {"blocks_per_sm" (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    "threads", "smem_bytes", "registers" and "local_bytes" (spills) a
    thread, "ks" (k-steps an A row), "nt" (n-tiles a group), "mt" (m16
    tiles an item)}. Needs the card."""
    import ctypes

    out = (ctypes.c_int * len(_AT_ANY_FIELDS))()
    err = _entry("demod_at_any_occupancy")(_KERNEL_DTYPES[dtype], config.samples_per_symbol, n_symbols,
                                           config.num_tones, int(decide), ctypes.addressof(out))
    _check_error(err, "demod_at_any occupancy")
    return dict(zip(_AT_ANY_FIELDS, out))


@functools.lru_cache(maxsize=16)
def _zero_starts(n: int, device: torch.device) -> torch.Tensor:
    """int32 zeros [n]: the data starts of n rows read in place, the
    tensor-core filterbank's span operand."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def _filterbank_rows(samples: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The samples as the filterbank kernels read them: bfloat16 and
    float32 rows as they are under float32 compute (bfloat16 samples are
    exact in float32), else cast to ``compute_dtype``."""
    keep = compute_dtype == torch.float32 and samples.dtype in (torch.bfloat16, torch.float32)
    return samples if keep else samples.to(compute_dtype)


def _filterbank_launch(name: str, kind: str, config: ModemConfig, samples: torch.Tensor, compute_dtype,
                       outputs) -> tuple[torch.Tensor, ...]:
    """Check the samples, allocate ``outputs(lead, S, device)`` and launch
    the filterbank kernel ``kind`` that _filterbank_operands picks on rows
    [R, L] of the samples (a view where the leading dimensions merge, the
    last dimension contiguous), S whole symbols a row. A launch counts under
    ``name``, or under OFF_WALK_KEYS["any"] off the compile-time walk; with
    ``":f32"`` for float32 compute."""
    x = _filterbank_rows(samples, compute_dtype)
    sps = config.samples_per_symbol
    s = x.shape[-1] // sps
    rows = x.reshape(-1, x.shape[-1])
    if s < 1 or rows.shape[0] < 1:
        raise ValueError(f"{name}: samples {tuple(x.shape)} hold no whole symbol")
    rows = rows if rows.stride(-1) == 1 else rows.contiguous()
    dtype = _check_cuda_input(name, rows, "samples")
    dev, r = rows.device, rows.shape[0]
    entry, route, basis = _filterbank_operands(kind, config, compute_dtype, dev)
    if route in ("any", "any_split"):
        head = (rows.data_ptr(), dtype, r, rows.stride(0))
    else:
        if r > 1 and rows.stride(0) < s * sps:  # overlapping rows: the span read needs a pitch >= a row
            rows = rows.contiguous()
        span = (r, rows.stride(0), _zero_starts(r, dev).data_ptr())
        head = (rows.data_ptr(), *span) if route == "mma" else (rows.data_ptr(), dtype, *span)
    outs = outputs(x.shape[:-1], s, dev)
    err = _entry(entry)(
        *head, s, sps, config.num_tones, basis.data_ptr(), *(o.data_ptr() for o in outs), _stream_handle(dev),
    )
    _check_launch(err, name, compute_dtype, route)
    return outs


def tone_energies_fused_ref(config: ModemConfig, samples: torch.Tensor, *, compute_dtype=torch.float32):
    """Plain version of tone_energies_fused (dsp.demod.tone_energies)."""
    from anet_torch.dsp.demod import tone_energies

    return tone_energies(config, samples, compute_dtype=compute_dtype)


def tone_energies_fused(config: ModemConfig, samples: torch.Tensor, *, compute_dtype=torch.float32):
    """Per-symbol per-tone energies, float32 [..., S, num_tones], of
    batch-major symbol-aligned samples [..., S * sps] (a trailing partial
    symbol is dropped): dsp.demod.tone_energies as one kernel. Samples round
    to ``compute_dtype`` (float32 or bfloat16), as the reference's operands
    do; the product runs in float32. Rows may be strided (a view past the
    preamble of whole frames) as long as the last dimension is contiguous.
    Any geometry, on the tensor cores: sps 32, 48, 64, 80 or 128 with at
    most 32 tones on tone_energies.cu's compile-time walk, the rest on
    filterbank_any.cu's (any sps, any tone count); float32 compute as a
    three-term bf16 split of the operands, the energies within 1e-5 of each
    plus 1e-6 of the symbol's largest of the plain version's."""
    if samples.device.type == "cpu":
        return tone_energies_fused_ref(config, samples, compute_dtype=compute_dtype)
    m = config.num_tones
    (energies,) = _filterbank_launch(
        "tone_energies_fused", "tone_energies", config, samples, compute_dtype,
        lambda lead, s, dev: (torch.empty(*lead, s, m, dtype=torch.float32, device=dev),),
    )
    return energies


def decide_tones_fused_ref(config: ModemConfig, samples: torch.Tensor, *, compute_dtype=torch.bfloat16):
    """Plain version of decide_tones_fused."""
    e = tone_energies_fused_ref(config, samples, compute_dtype=compute_dtype)
    return torch.argmax(e, dim=-1).to(torch.int32), e.amax(-1), e.sum(-1)


def decide_tones_fused(config: ModemConfig, samples: torch.Tensor, *, compute_dtype=torch.bfloat16):
    """The filterbank with the symbol decision folded in: (tone int32,
    best float32, total float32), each [..., S], of batch-major
    symbol-aligned samples [..., S * sps]; argmax ties go to the first tone.
    The contract of frame.frame_result_from_tone_decisions. Same inputs as
    tone_energies_fused, but bfloat16 compute by default, as the
    reference's."""
    if samples.device.type == "cpu":
        return decide_tones_fused_ref(config, samples, compute_dtype=compute_dtype)

    def outputs(lead, s, dev):
        shape = (*lead, s)
        return (torch.empty(shape, dtype=torch.int32, device=dev),
                torch.empty(shape, dtype=torch.float32, device=dev),
                torch.empty(shape, dtype=torch.float32, device=dev))

    return _filterbank_launch("decide_tones_fused", "decide_tones", config, samples, compute_dtype, outputs)


# --- sync_search_blockmax: block maxima of the search quality -----------------


def sync_search_blockmax_ref(seg: torch.Tensor, template: torch.Tensor, out_len: int, template_energy):
    """Plain version of sync_search_blockmax: the blockwise quality at every
    lag, reshaped to [..., out_len // 128, 128], maximum of each block."""
    q = _search_quality(seg, template, out_len, template_energy)
    return q.reshape(*q.shape[:-1], out_len // _ROW, _ROW).amax(-1)


def sync_search_blockmax(seg: torch.Tensor, template: torch.Tensor, out_len: int, template_energy):
    """Per-128-lag block maxima of the blockwise preamble match quality,
    float32 [B, out_len // 128]: the first phase of the two-phase search
    (the caller folds the blocks, and a probe refines the lag within the
    winner). Equivalent to (but never materializing)::

        corr = correlate_template(seg, template)[..., :out_len]
        q = blockwise_match_quality(seg, corr, k, template_energy)
        return q.reshape(..., out_len // 128, 128).max(-1)

    ``seg``, ``template`` and ``template_energy`` as sync_search_fused
    takes them; ``out_len`` a multiple of 128."""
    if out_len % _ROW or out_len < _ROW:
        raise ValueError(f"sync_search_blockmax: out_len {out_len} must be a positive multiple of {_ROW}")
    if seg.device.type == "cpu":
        return sync_search_blockmax_ref(seg, template, out_len, template_energy)
    name = "sync_search_blockmax"
    args = _search_launch_args(name, seg, template, out_len)
    out = torch.empty(seg.shape[0], out_len // _ROW, dtype=torch.float32, device=seg.device)
    te, te_val = _energy_operand(name, template_energy, seg.device)
    err = _entry("search_blockmax")(
        *args, out_len, _address(te), te_val, out.data_ptr(), _stream_handle(seg.device),
    )
    _check_launch(err, name, seg.dtype)
    return out


def demod_at_buffer_pad(
    config: ModemConfig, n_symbols: int, start_bound: int, live_length: int
) -> int:
    """Extra zero samples after a ``live_length``-sample stream buffer: the
    reference's tail pad for its span DMAs (anet.kernels.demod_at_buffer_pad),
    kept so both packages size the carry buffer alike and checkpoints move
    between them. The kernels here read zeros past the end instead."""
    sps = config.samples_per_symbol
    r_syms = 128 // sps
    pre = config.preamble_symbols * sps
    p = -(-n_symbols // r_syms)
    pv = -(-p // 8) * 8
    sv = (-(-(pv + 2) // 8)) * 8 + 8
    lane_pad = -live_length % 128
    rows_total = (live_length + lane_pad) // 128
    hi_max = (start_bound + pre) // 128
    pad_rows = max(0, hi_max + sv + 8 - rows_total)
    return lane_pad + pad_rows * 128
