"""Smoke run of the PyTorch/CUDA port (anet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. build the CUDA kernels from anet_torch/kernels/csrc (fourteen sources,
   one nvcc each, all started together, sm_90a);
2. hold each kernel against its plain PyTorch version at its main path's
   shapes on a 256-stream subset, then time kernel and plain version at the
   full batch: the uncoded paths' four kernels on mfsk16-fast (payload 256,
   chunk 36,352, buffer 76,288), with the int8 instantiations of three of
   them (frames quantized x127, buffers as an int8 carry holds them) and
   sync_search_blockmax on the search's segment (both searches also with
   the template energy a float32 scalar on the card, as the stream passes
   it, under torch.cuda.set_sync_debug_mode("error"): bit-equal to a
   float's, no host read), the coded paths' three on
   mfsk4-coded (with demod_at_energies_fused on int8 buffers, and on
   float32 ones as the three-term split: compare_split_energies, its LLRs
   through viterbi_trellis giving the plain energies' bits, payloads and
   verdicts) (payload 256, chunk 70,144, buffer 143,872, trellis 2,150
   steps; the trellis also with a masked tail and at the 102-step header
   probe;
   probe_at_fused also with its template energy a float32 scalar on the
   card, as the locked step passes it, bit-equal and timed), and
   the three of the variable-length, oversized-window and one-shot paths on
   mfsk16-fast (correlate_fused at a chunk of two shortest frames, 23,552
   lags, also timed on its float32 routes; decide_tones_tm at a frame plus
   8 symbols, bf16 on the tensor cores, also on float32 data (the
   three-term split, held with compare_split_decisions, also off 16 bytes)
   and on bf16 rows off 16 bytes (B - 1 streams); gather_rows_fused
   at one frame out of the 76,288-sample buffer, bf16, also on int8 (its
   int8 numbers) and float32 buffers, starts at every byte residue mod 16;
   demod_at_fused also timed at the dynamic parse's max-length
   window, 536 symbols from starts in a 23,552-sample chunk), these also
   beside the one
   PyTorch call that computes the same function where there is one; and
   the OFDM equalizer ofdm_track_decide_fused on 256 drifted frames
   (+-100..150 ppm) of each constellation (QPSK, 16-QAM, 64-QAM), tracked
   and untracked, timed on ofdm-fast at B = 8,192, batch-major and as the
   time-major receiver's [B, S, C] view of [S, C, B] points, and past
   long frames (phase_kernels_ofdm_long: ofdm-coded streams of S = 87, 172,
   302 (the staged route's longest), 303 and 343 data symbols, B = 1,024,
   both layouts bit-equal on the route kernels._ofdm_track_route picks, the
   block route at every one, held and timed against the bound and the
   block route's arithmetic floor; the staged route forced where a stream
   fits, held by the same rules and timed beside it); the batch-major
   filterbank (tone_energies_fused, decide_tones_fused) on mfsk16-fast
   data sections read in place, bfloat16 compute (the tensor cores) held
   against the plain versions at 256 rows and at B = 16,384 (tones
   bit-equal) and timed there, then its float32-compute route (the
   tensor cores' three-term bf16 split) on bf16 rows and on float32 rows,
   held against the plain versions at 256 rows and at B = 16,384 with its
   stated tolerance (compare_split: every energy within 1e-5 of itself
   plus 1e-6 of its symbol's largest, best and total alike, tones equal
   but at near-ties, whose count it prints) and timed there against its
   bound (bytes, or its 3 or 6 products at the bf16 peak); the
   tensor-core search (sync_search_fused) timed at the coded (mfsk4-coded:
   k 1,024, chunk 70,144) and OFDM stream (ofdm-fast: chunk 4,736)
   geometries, B = 8,192, each against its bound; and the float32 routes
   of the other kernels in kernels.F32_ROUTES: sync_search_fused,
   sync_search_blockmax and correlate_fused (seg and template split into
   bf16 hi + lo), demod_at_fused and demod_probe_fused (the three-term
   bf16 split on the tensor cores, held with compare_split_decisions: best
   and total within the split's tolerance, tones equal but at near-ties of
   the plain energies, whose count it prints; the probe's offsets equal,
   cmax and energy within RTOL), demod_at_energies_fused (the same split,
   held with compare_split_energies), decide_frame_tm and decide_tones_tm
   (the same split on float32 frames: check_frame_split, tones read back
   from the packed words, words and CRC counts equal but at near-ties,
   the quality sums within the split's tolerance; compare_split_decisions),
   each held against its plain version and timed with it at the main
   shape against its bound (the "<name>:f32" numbers); and the time-major
   pair off decide_frame_tm's walk (phase_kernels_generic):
   decide_tones_tm at mfsk8-audible (sps 48, 8 tones) and mfsk32-dense
   (sps 80, 32 tones as 8 n-tiles, the basis in shared memory) on
   decide_frame_tm.cu's tensor-core walk, bf16 and float32 (its route
   asserted; compare_walk_tones: tones equal but at near-ties, bf16 best
   and total within RTOL of the symbol's largest energy, float32 as
   compare_split_decisions), on 256 streams and at B = 16,384, timed there
   against its bound (decide_tones_tm's "presets"); and the runtime-geometry
   walk of every custom geometry (csrc/frame_tm_any.cu,
   phase_kernels_tm_any at TM_ANY_SHAPES: decide_frame_tm at sps 40 with
   16 tones, aligned-custom's shape, and at sps 80 with 16 and sps 1,920
   with 16, bf16, int8 and float32; decide_tones_tm at sps 96 with 32
   tones, sps 40 with 8 and sps 128 with 64, bf16 and float32;
   check_frame_any: words and CRC counts bit-equal, the sums within ANY_RTOL,
   float32 as check_frame_split; the tones with compare_walk_tones at
   ANY_RTOL; on 256 streams and at the full batch, timed there against
   the plain version and the bound); and the search kernels past the
   one-shot stage (phase_kernels_search_long: search_core.cuh's slab
   route at templates of 15,360 and 61,440 samples, every dtype pair, B =
   64, held and timed: each search row's "slab"; sync_search_fused also at
   stream-slow-f32's own float32 shape, B = 1,024 and its chunk's lags:
   "slab"."stream-slow-f32"); and the batch-major filterbank off
   the align+demod kernels' geometry
   (phase_kernels_filterbank_generic): its tensor-core routes at the two
   stream paths' shapes (tone_energies_fused and decide_tones_fused,
   mfsk32-dense bf16 compute with 32 tones' basis in shared memory, and
   mfsk8-audible float32 compute as the split at sps 48; held with
   compare_mma_tones and compare_split at 256 rows and B = 16,384, timed
   there), and its runtime-geometry walk (csrc/filterbank_any.cu, the
   route of every custom geometry off tone_energies.cu's compile-time
   walks) at sps 40 with 8 tones (B = 4,096), sps 40 with 16 (B = 8,192,
   stream-custom-f32's), sps 480 with 16 (B = 1,024, stream-slow-f32's),
   sps 1,920 with 16 (B = 256) and sps 160 with 64 (B = 2,048), bfloat16 compute on bf16 rows and float32 compute on
   float32 rows, held with compare_mma_tones (ANY_RTOL) and
   compare_split on 256 rows and at the full batch, timed there against
   the plain version and the bound (bytes, or the products at the bf16
   peak); and the align+demod kernels off their compile-time walk
   (phase_kernels_demod_at_any: csrc/demod_at_any.cu, the rest of the
   reference's gate, 128 % sps == 0): demod_at_fused,
   demod_at_energies_fused and demod_probe_fused on bf16, int8 and float32
   buffers at sps 16 with 4 tones and sps 128 with 32 (the two new stream
   paths' modems) on 256 streams and at B = 8,192, held against the plain
   versions (check_at_any: the route and launch keys asserted; int8 tones,
   best and energies bit-equal; bf16 within ANY_RTOL of the symbol's
   largest energy; float32 the split's tolerance) and timed there against
   the plain version and the bound; at sps 4 with 2 tones, sps 8 with 4,
   sps 64 with 32 and sps 128 with 64 held on 256 streams, data starts at
   every byte residue mod 16;
3. the aligned receivers at full size, frames transmitted on the card and
   demodulated time-major: 16,384 mfsk16-fast frames through
   decide_frame_tm ("aligned"), 8,192 mfsk4-coded frames through the
   filterbank product, the LLRs and viterbi_trellis ("aligned-coded");
4. the locked streaming receivers at full size: 8,192 streams of one
   acquisition gap and 6 back-to-back frames (bf16 capture), once cold
   (acquisition runs the search kernel) and once with a warm lock seeded
   at the first frame, on mfsk16-fast ("stream": the merged probe+demod
   kernel) and on mfsk4-coded ("stream-coded": probe, energies and trellis
   kernels), and "stream-coded-f32": the same mfsk4-coded capture in
   float32 through receive_stream's defaults, a float32 carry and float32
   compute (demod_at_energies_fused's three-term split, viterbi_trellis,
   sync_search_fused; the plain row-aligned probe, never probe_at_fused);
5. the variable-length streams at B = 8,192, header-declared lengths up to
   256: "stream-dynamic" (always-search, two candidates a chunk, payloads
   64, 64, 256, 128, 64, 64 back to back: correlate_fused and
   demod_at_fused), "stream-dynamic-lock" (payloads 64, 256, 128, 64, 256,
   128, cold and warm: probe_at_fused, demod_at_fused) and
   "stream-dynamic-coded" (the same on mfsk4-coded-stream: probe, energies
   and two trellis launches a chunk); every payload and declared length
   must equal what was sent;
6. "aligned-window": 16,384 time-major frames followed by 8 symbols of
   noise through demodulate_frame_tm (decide_tones_tm); "oneshot": 2,048
   captures with the frame at a random start below 2,000 through
   receive_frame (its filterbank tone_energies_fused) and
   receive_frame_dynamic, then the same composition with
   aligned_gather(mode="roll") (gather_rows_fused), bit-equal frames, and
   the roll gather of the captures quantized as an int8 carry holds them
   (gather_rows_fused's int8 instantiation), bit-equal to the default;
7. the OFDM family: "aligned-ofdm" (family.aligned_demod_fn on 8,192
   ofdm-fast frames, float32: 64 distinct streams, each resampled on the
   card to its own clock offset in +-150 ppm, at 16 dB, tiled),
   "aligned-ofdm-tm" (the same frames time-major, ofdm.demodulate_frame_tm),
   "aligned-ofdm-max" (2,048 ofdm-max frames, 64-QAM coded, at 26 dB:
   ofdm_track_decide_fused and viterbi_trellis), "stream-ofdm" (the locked
   stream of phase 4 on ofdm-fast, chunk 4,736, cold and warm: probe_at_fused,
   sync_search_fused, ofdm_track_decide_fused), "oneshot-ofdm"
   (ofdm.receive_frame on 2,048 captures, frame start random below 2,000,
   20 dB), "stream-dynamic-ofdm" (B = 2,048, payloads 64, 256, 128 in
   frame lock, cold and warm), "aligned-ofdm-long" (1,024 ofdm-coded
   frames of 4,096 bytes, 343 data symbols, at 16 dB, batch-major and
   time-major: the equalizer's block route and viterbi_trellis, never
   its staged route) and "aligned-ofdm-4k" (1,024 ofdm-fast frames of
   4,096 bytes, 172 data symbols, the same way: the block route, never
   the staged one);
8. the fifth slice: "aligned-int8" (the 16,384 frames of phase 3 quantized
   x127, demodulate_frame_tm with int8 compute: decide_frame_tm's int8
   instantiation), "stream-int8" (phase 4's capture quantized with
   quantize_int8 into an int8 carry, cold and warm: demod_probe_fused and,
   cold, demod_at_fused in int8, the search on a bf16 copy of the segment),
   "stream-coded-int8" (the mfsk4-coded stream on an int8 carry, warm:
   the plain row-aligned probe on the int8 buffer, as the reference
   probes every buffer but a bf16 one, demod_at_energies_fused in int8,
   viterbi_trellis), "aligned-bm" (demodulate_frame on 16,384
   batch-major bf16 frames: tone_energies_fused), "aligned-bm-decide"
   (the same batch through decide_tones_fused and
   frame_result_from_tone_decisions; verdicts equal to aligned-bm's) and
   "search-blockmax" (the cold stream's acquisition segment, B = 8,192:
   sync_search_blockmax held against sync_search_fused);
9. the clock tracker and the capture-resident scan: "oneshot-tracked"
   (receive_frame_tracked, the symbol-clock tracker, on 2,048 float32
   captures of 38,400 samples, each drifted on the card by 700-1,000 ppm
   either way at 14 dB: every frame ok, every drift estimate of the
   offset's opposite sign within 15% + 30 ppm, and the block receiver
   losing frames on the same batch; the tracker is plain PyTorch, so the
   path launches no kernel), "stream-tracked"
   (receive_stream(track=True) on phase 4's capture drifted alike, B =
   8,192: sync_search_fused, then the tracker) and "stream-resident"
   (receive_stream(lock=True, resident=True) on phase 4's capture, cold and
   warm: the capture-resident scan, sync_search_fused and demod_at_fused on
   the padded capture, never probe_at_fused or demod_probe_fused; its
   frames and final carry equal to the carry path's run on the same
   capture, whose launches do not count);
10. int8 carries for the variable-length and OFDM receivers, the channel
   and the aligned receiver in float32: "stream-dynamic-int8" (phase 5's stream-dynamic-lock capture,
   bf16, entering init_carry(dtype=torch.int8) carries, so
   receive_stream_dynamic quantizes it at ingest; cold and warm:
   sync_search_fused on a bf16 copy of the segment, demod_at_fused's int8
   instantiation, the plain row-aligned probe, never probe_at_fused),
   "stream-ofdm-int8" (phase 7's stream-ofdm capture quantized with
   quantize_int8 into int8 carries, cold and warm: sync_search_fused,
   ofdm_track_decide_fused, the plain probe) and "aligned-channel" (phase
   3's 16,384 frames through channel.apply_channel on the card, 10 dB with
   a half-amplitude echo 3 samples late, then time-major into
   demodulate_frame_tm: every frame ok, the measured SNR of the added
   noise within 0.1 dB of the target, suggest_model on the mean snr_db
   printed, and classify_capture naming each of four channelled presets
   first), "aligned-f32" (phase 3's receiver on 16,384 float32 frames with
   float32 compute: decide_frame_tm's three-term split, never its bf16 or
   int8 route) and "aligned-window-f32" (phase 6's window in float32 rows
   and compute: decide_tones_tm's split, never its bf16 route), every
   frame ok with equal payloads; and the two presets off the align+demod
   kernels' and decide_frame_tm's geometry (sps 32, 64 or 128 with at
   most 16 tones: kernels._tensor_core_geometry): "aligned-audible"
   (16,384 bf16 mfsk8-audible frames, 48 samples a symbol, through
   demodulate_frame_tm: 3 bits a symbol take decide_tones_tm, on
   decide_frame_tm.cu's tensor-core walk at sps 48, its bf16 route),
   "aligned-dense-f32" (16,384 float32 mfsk32-dense frames, 32 tones:
   decide_tones_tm:f32, the walk's split at 8 n-tiles; neither aligned
   path launches frame_tm_any, the batch-major filterbank or the
   other dtype's route), "stream-audible-f32" (phase 4's stream on
   mfsk8-audible at receive_stream's float32 defaults, cold and warm: the
   search, then the aligned slice through the batch-major receiver,
   tone_energies_fused's tensor-core split at sps 48:
   tone_energies_fused:f32; the plain probe) and "stream-dense" (the same
   on mfsk32-dense with a bf16 carry, locked: tone_energies_fused's
   bfloat16 route at 32 tones, probe_at_fused); none of them launches an
   align+demod kernel or decide_frame_tm (OFF_THE_WALK), and the streams
   launch neither decide_tones_tm nor a body off the compile-time walks;
   and "stream-custom-f32" (phase 4's stream at receive_stream's float32
   defaults, cold and warm, on a custom config no preset has, 48 kHz,
   1,200 baud, 16 tones from 600 Hz: sps 40, so the search, then the
   aligned slice through the batch-major receiver on filterbank_any.cu's
   split, filterbank_any:f32; never the compile-time walk, its bfloat16
   route, decide_tones_tm or the probe); "aligned-custom" (phase 3's
   aligned time-major receiver on 16,384 bf16 frames of the same modem:
   decide_frame_tm at sps 40 on frame_tm_any.cu, frame_tm_any's bfloat16
   route, never decide_frame_tm's walk or another dtype's route); and
   "stream-slow-f32" (phase 4's stream at receive_stream's float32
   defaults, cold and warm, B = 1,024, on a slow voice-band modem, 48 kHz,
   100 baud, 16 tones from 600 Hz: sps 480, whose 15,360-sample preamble
   passes the search's one-shot stage in float32, so sync_search_fused:f32
   on search_core.cuh's slab route, then filterbank_any:f32; never a
   bfloat16 search or filterbank route); and two custom modems within the
   reference's gate off the align+demod kernels' compile-time walk:
   "stream-sps16-int8" (phase 4's stream on an int8 carry, cold and warm,
   48 kHz, 3,000 baud, 4 tones: sps 16, two symbols an A row of
   demod_at_any.cu; demod_probe_fused and demod_at_fused in int8 on it,
   demod_at_any:int8, never the walk's keys or the slice) and
   "stream-resident-m32" (phase 9's capture-resident scan against the
   carry path, cold and warm, bf16, 48 kHz, 375 baud, 32 tones: sps 128,
   8 n-tiles; demod_at_fused on demod_at_any.cu, demod_at_any);
11. the scale-out layer (anet_torch.parallel, its positions all on the one
   card) and the modem CLI: "sharded-demod" (16,384 aligned mfsk16-fast
   frames, float32 compute, sharded_demodulate on 4 positions and on
   make_mesh(): payloads and verdicts equal to one unsharded
   demodulate_frame call), "ber-sweep" (ber_sweep on 4 positions, payload
   256, 4,096 frames a point at the preset's operating SNR -12, -6, 0 and
   +6 dB: exact totals, BER non-increasing, FER 0 at the top point),
   "sharded-long" (one stream of 4 positions x 4 chunks of 36,352, a frame
   across each inner boundary, 14 dB: sharded_receive_long_capture
   searching, locked, and as two super-steps joined by resume, each equal
   to one unsharded receive_stream call in the same mode), "sharded-grid"
   (8,192 streams over 2 x 2 positions, 3 chunks a segment, float32 capture
   7.1 GB: sharded_receive_capture_grid equal to unsharded receive_stream),
   "sharded-dynamic" (header-declared lengths, chunk 11,776: the long
   dynamic capture as two super-steps, then the dynamic grid at B = 2,048
   on 2 x 2, equal to unsharded receive_stream_dynamic) and "cli"
   (anet_torch.cli.main in-process: modem-tx of 1 kB to a WAV, modem-rx,
   modem-stream-rx --lock over two halves with --save-state and --resume,
   sweep, models; every byte back, every exit code 0);
12. the three demos of anet_torch.examples, each logged with its wall
   time, Msamples/s and real-time factor (seconds on the air over wall
   seconds): "example-file" (file_over_sound's main on a 16 KiB seeded
   file: 64 wire frames of 264 bytes on mfsk16-fast, one capture of about
   2.4 M samples with no batch axis, the stream's default call, float32
   and always searching: sync_search_fused and demod_at_fused every
   chunk; the file back byte for byte), "example-adaptive"
   (adaptive_modem's main at 9 dB with 600, then 16,384 bytes: the
   one-shot probe on fsk2-robust, tone_energies_fused with float32
   compute, then the ofdm-coded stream: sync_search_fused,
   ofdm_track_decide_fused, viterbi_trellis; ofdm-coded picked, the
   transfer byte for byte) and "example-opus" (opus_over_sound's legs on
   10 s of its melody: Opus frames where libopus loads, else seeded
   stand-ins of their size, "opus": false; the ofdm-coded stream at 14 dB
   with two echoes; every frame back byte for byte);
13. the launch count of every kernel during phases 3-12, read per path (each
   path's counts start at 0 just before it; int8 launches count under
   "<name>:int8", those of the float32 routes of kernels.F32_ROUTES under
   "<name>:f32"): every kernel of a path must have launched there (a bare
   name on any of its float routes), and none that the reference's routing
   keeps off it (ABSENT); the float32-compute paths (oneshot,
   sharded-demod, cli) give the payloads and verdicts of the plain
   filterbank (plain_filterbank, uncounted);
14. the host edge, outside the paths' counts: "lan" (no device code, no
   kernel launched): the native C++ core built with g++ from
   anet_torch/net/csrc, a native DiscoveryResponder on 127.0.0.1 found by
   discover_receivers and pinged 200 times (round trip) after a datagram
   whose length prefix narrows to a negative int, then 10 s of a
   48 kHz stereo 440 Hz tone written by numpy: with libopus, the WAV
   through anet_torch.cli.main(["tx", wav, "127.0.0.1", "--port", p,
   "--unpaced"]) to an AnetReceiver with a BufferSink, every sent frame
   received and played, no decode error; without it, the hello and
   capability handshake and the tone's PCM as raw AudioData frames at the
   negotiated 4,096-byte cap through AudioStreamServer, every frame intact
   and ReceiverError feedback back ("opus": false on its line); and
   "trace": one warm chunk step of the locked mfsk16-fast stream (B =
   8,192, the chunk where the first frame completes) under
   anet_torch.obs.profiling.device_trace (torch.profiler) and a StageTimer
   stage: the .pt.trace.json it writes must name demod_probe_fused's probe
   kernel (csrc/demod_probe.cu's probe_kernel, demangled), which the launch
   counts must show too.
The search kernels' rows carry their slab route's numbers at templates of
15,360 and 61,440 samples under "slab". The line before the last is a JSON
object with each kernel's numbers (the
five kernels with an int8 instantiation carry its numbers under "int8", the
ten with a float32 route of their own its numbers under "f32"; the
batch-major filterbank's are on float32 rows, with its bf16 rows' under
"f32"."bf16_rows", and its numbers at mfsk32-dense and mfsk8-audible
under "presets", as decide_tones_tm's walk at both presets and dtypes;
ofdm_track_decide_fused's block route under "block", S = 343
batch-major, its other shapes and the staged route's under
"block"."shapes"; the two bodies off the compile-time walks' geometry
have rows of their own, whose launches the wrappers count under
kernels.OFF_WALK_KEYS: frame_tm_any, on aligned-custom's path, its
numbers decide_frame_tm at sps 40 with 16 tones, bf16, under "f32" on
float32, every shape of TM_ANY_SHAPES under "shapes"; filterbank_any, on stream-custom-f32's path, its
numbers tone_energies_fused at sps 40 with 8 tones under bf16 compute,
under "f32" under float32 compute on float32 rows, decide_tones_fused's
under "decide_tones", sps 1,920 and 160 beside them; demod_at_any, on
stream-sps16-int8's and stream-resident-m32's paths, its numbers
demod_at_fused at sps 16 with 4 tones, B = 8,192, bf16, the other two
wrappers beside them, sps 128 with 32 tones and the shapes held at 256
streams under their labels, int8 and float32 under "int8" and "f32"),
and the last line the JSON verdict with the device's name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from anet_torch import kernels, parallel
from anet_torch.channel import ChannelConfig, apply_channel, multipath
from anet_torch.dsp import family, fec, ofdm
from anet_torch.dsp import frame as tframe
from anet_torch.dsp.demod import bit_llrs, decide_symbols
from anet_torch.dsp.params import ModemConfig
from anet_torch.dsp import sync as tsync
from anet_torch.dsp.pipeline import receive_frame, receive_frame_dynamic, receive_frame_tracked, transmit
from anet_torch.dsp.sync import preamble_waveform
from anet_torch.kernels.build import build_all
from anet_torch.models import OPERATING_SNR_DB, classify_capture, get_model, suggest_model
from anet_torch.profile_stream import (
    DYNAMIC_LENS,
    DYNAMIC_LOCK_LENS,
    GAP0,
    back_to_back_capture,
    drifted_oneshot_captures,
    drifted_stream_capture,
    warm_lock_carry,
)
from anet_torch.stream import (
    _buffer_len,
    _slide_buffer,
    init_carry,
    quantize_int8,
    receive_stream,
    receive_stream_dynamic,
)

MODEL = "mfsk16-fast"
CODED_MODEL = "mfsk4-coded"
DYNAMIC_CODED_MODEL = "mfsk4-coded-stream"  # fec_interleave == 1
OFDM_MODEL = "ofdm-fast"
OFDM_MAX_MODEL = "ofdm-max"  # 64-QAM, coded
OFDM_QAM_MODELS = ("ofdm-fast", "ofdm-turbo", "ofdm-max")  # 2, 4 and 6 bits a carrier
AUDIBLE_MODEL = "mfsk8-audible"  # sps 48, 8 tones: off the tensor-core walks
DENSE_MODEL = "mfsk32-dense"  # sps 80, 32 tones: off the tensor-core walks
PAYLOAD = 256  # also the variable-length paths' max_payload_len
SHORT_PAYLOAD = 64  # the shortest frame of the variable-length paths
ALIGNED_B = 16384
STREAM_B = 8192  # also the coded aligned batch
ONESHOT_B = 2048
COMPARE_B = 256
N_FRAMES = 6  # after one gap of GAP0 samples
N_LAGS = 5
RTOL = 1e-3  # bf16 inputs, float32 sums in another order than the plain version
OFDM_DISTINCT = 64  # distinct drifted streams of an aligned OFDM batch, tiled
OFDM_PPM = 150.0  # clock offsets drawn in +-OFDM_PPM
OFDM_SNR_DB = {"ofdm-fast": 16.0, "ofdm-turbo": 24.0, "ofdm-max": 26.0}
OFDM_RTOL = 1e-4  # float32 throughout: LLRs (of their scale) and evm2
GATE_EPS = 1e-4  # a gate may part from the plain version's only this close to a tie
ANY_RTOL = 1e-5  # filterbank_any.cu and frame_tm_any.cu, bf16: bf16 products exact, float32 sums in another order
TM_ANY_ROW = kernels.OFF_WALK_KEYS["tm_any"]  # the kernels line's row of csrc/frame_tm_any.cu
FILTERBANK_ROW = kernels.OFF_WALK_KEYS["any"]  # the row of csrc/filterbank_any.cu, the runtime-geometry walk
AT_ANY_ROW = kernels.OFF_WALK_KEYS["at_any"]  # the row of csrc/demod_at_any.cu, the align+demod kernels off their walk
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_S = 67e12  # H100 SXM float32 peak outside the tensor cores
INT8_OPS_S = 1979e12  # H100 SXM dense int8 tensor-core peak
F32_SPLIT_PRODUCTS = 6  # bf16 products of a float32 sample and basis entry in the three-term split
SEED = 0
DEV = torch.device("cuda")

REPLACES = {
    "decide_frame_tm": ("anet_torch/kernels/csrc/decide_frame_tm.cu", "anet/kernels/__init__.py:488"),
    "sync_search_fused": ("anet_torch/kernels/csrc/sync_search.cu", "anet/kernels/__init__.py:1095"),
    "demod_at_fused": ("anet_torch/kernels/csrc/demod_at.cu", "anet/kernels/__init__.py:1992"),
    "demod_probe_fused": ("anet_torch/kernels/csrc/demod_probe.cu", "anet/kernels/__init__.py:2307"),
    "viterbi_trellis": ("anet_torch/kernels/csrc/viterbi.cu", "anet/kernels/__init__.py:754"),
    "demod_at_energies_fused": ("anet_torch/kernels/csrc/demod_at_energies.cu", "anet/kernels/__init__.py:1918"),
    "probe_at_fused": ("anet_torch/kernels/csrc/demod_probe.cu", "anet/kernels/__init__.py:1621"),
    "correlate_fused": ("anet_torch/kernels/csrc/correlate.cu", "anet/kernels/__init__.py:891"),
    "decide_tones_tm": ("anet_torch/kernels/csrc/decide_frame_tm.cu", "anet/kernels/__init__.py:269"),
    "gather_rows_fused": ("anet_torch/kernels/csrc/gather_rows.cu", "anet/kernels/__init__.py:1415"),
    "ofdm_track_decide_fused": ("anet_torch/kernels/csrc/ofdm_track.cu", "anet/kernels/__init__.py:2648"),
    "tone_energies_fused": ("anet_torch/kernels/csrc/tone_energies.cu", "anet/kernels/__init__.py:87"),
    "decide_tones_fused": ("anet_torch/kernels/csrc/tone_energies.cu", "anet/kernels/__init__.py:172"),
    "sync_search_blockmax": ("anet_torch/kernels/csrc/search_blockmax.cu", "anet/kernels/__init__.py:1300"),
    # decide_tones_tm (and decide_frame_tm, :488) off the tensor-core walk's geometry
    TM_ANY_ROW: ("anet_torch/kernels/csrc/frame_tm_any.cu", "anet/kernels/__init__.py:269"),
    # tone_energies_fused (and decide_tones_fused, :172) off the compile-time walk's geometry
    FILTERBANK_ROW: ("anet_torch/kernels/csrc/filterbank_any.cu", "anet/kernels/__init__.py:87"),
    # demod_at_fused (and demod_at_energies_fused, :1918, demod_probe_fused's demod, :2307) off the walk's geometry
    AT_ANY_ROW: ("anet_torch/kernels/csrc/demod_at_any.cu", "anet/kernels/__init__.py:1992"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float, flops_s: float = BF16_FLOPS_S) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the peak
    for their type (bf16 tensor cores unless ``flops_s`` says otherwise)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_flops / flops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_and_bound(results: dict, calls: dict, work: dict, library: dict | None = None) -> None:
    """Time each kernel and its plain version (``calls``: name -> (call,
    kernel, plain version)) and add its bound (``work``: name -> the
    arguments of bound_ms) to ``results``. ``library``: name -> a call of
    the one PyTorch function that computes the same thing, timed as a
    yardstick and used nowhere in the port."""
    for name, (call, kern, ref) in calls.items():
        results[name]["ms"] = time_ms(lambda: call(kern))
        results[name]["plain_ms"] = time_ms(lambda: call(ref))
        torch.cuda.empty_cache()
    for name, fn in (library or {}).items():
        results[name]["library_ms"] = time_ms(fn)
        torch.cuda.empty_cache()
    for name, args in work.items():
        r = results[name]
        r["bound_ms"], r["bound_by"] = bound_ms(*args)
        lib = f", library {r['library_ms']:.3f} ms" if "library_ms" in r else ""
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{lib}, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")


def log_search_time(label: str, seg: torch.Tensor, tpl: torch.Tensor, chunk: int,
                    name: str = "sync_search_fused") -> None:
    """Time sync_search_fused (or correlate_fused) on ``seg`` at another
    geometry or dtype than its row's and log it against its bound: the
    segment read once, the output written once, the 2 k out_len B
    operations at the bf16 peak, whatever the dtypes."""
    k, b = tpl.shape[-1], seg.shape[0]
    if name == "sync_search_fused":
        te = float((tpl.float() ** 2).sum())
        ms = time_ms(lambda: kernels.sync_search_fused(seg, tpl, chunk, te))
        out_bytes = 8
    else:
        ms = time_ms(lambda: kernels.correlate_fused(seg, tpl, chunk))
        out_bytes = 4 * chunk
    bound, by = bound_ms(b * ((chunk + k - 1) * seg.element_size() + out_bytes), 2 * k * chunk * b)
    log(f"  {name} ({label}: B {b}, out_len {chunk}, k {k}, seg "
        f"{str(seg.dtype).removeprefix('torch.')}, template {str(tpl.dtype).removeprefix('torch.')}): "
        f"kernel {ms:.3f} ms, bound {bound:.3f} ms ({by})")
    torch.cuda.empty_cache()


def log_demod_time(label: str, cfg, buf: torch.Tensor, starts: torch.Tensor, n_sym: int) -> None:
    """Time demod_at_fused on ``buf`` at another geometry or dtype than its
    row's and log it against its bound: each stream's data span read once,
    12 bytes a symbol written, the filterbank's operations on the tensor
    cores at the peak of the buffer's dtype (int8, or bf16: one product for
    bfloat16 buffers, the three-term split's six for float32)."""
    b, sps, m = buf.shape[0], cfg.samples_per_symbol, cfg.num_tones
    ms = time_ms(lambda: kernels.demod_at_fused(cfg, buf, starts, n_sym))
    peak = INT8_OPS_S if buf.dtype == torch.int8 else BF16_FLOPS_S
    n_products = F32_SPLIT_PRODUCTS if buf.dtype == torch.float32 else 1
    bound, by = bound_ms(b * (n_sym * (sps * buf.element_size() + 12) + 4),
                         n_products * b * n_sym * 2 * sps * 2 * m, peak)
    log(f"  demod_at_fused ({label}: B {b}, buffer {buf.shape[-1]}, {n_sym} symbols, "
        f"{str(buf.dtype).removeprefix('torch.')}): kernel {ms:.3f} ms, bound {bound:.3f} ms ({by})")
    torch.cuda.empty_cache()


def time_f32_route(results: dict, name: str, call, n_bytes: float, n_ops: float, peak: float) -> None:
    """Time a kernel's float32 route (``call(f)`` runs it with f the wrapper
    or its plain version) and its plain version, with its bound, into
    ``results[name + ":f32"]``, whose max_abs_err is already there."""
    r = results[f"{name}:f32"]
    r["ms"] = time_ms(lambda: call(getattr(kernels, name)))
    r["plain_ms"] = time_ms(lambda: call(getattr(kernels, f"{name}_ref")))
    r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, n_ops, peak)
    log(f"  {name} (float32 route): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()


def compare(name: str, got, want, exact: tuple[int, ...], close: tuple[int, ...],
            atol: float = 1e-6, rtol: float = RTOL) -> float:
    """Hold kernel outputs against the plain version's: the ``exact``
    positions bit-equal, the ``close`` ones within ``rtol`` (plus ``atol``,
    for outputs that are sums with cancellation). Returns the max absolute
    error over the ``close`` outputs."""
    worst_abs, worst_rel, report = 0.0, 0.0, []
    for i in exact:
        bad = int((got[i] != want[i]).sum())
        report.append(f"out{i} mismatches {bad}")
        if bad:
            raise AssertionError(f"{name}: output {i} differs in {bad} places")
    for i in close:
        g, w = got[i].double(), want[i].double()
        diff = (g - w).abs()
        rel = diff / w.abs().clamp_min(1e-30)
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float(rel.max()))
        bad = int((diff > rtol * w.abs() + atol).sum())
        report.append(f"out{i} beyond rtol {bad}")
        if bad:
            raise AssertionError(f"{name}: output {i} beyond rtol {rtol} in {bad} places")
    log(f"  {name}: max abs {worst_abs:.3e} max rel {worst_rel:.3e}; " + ", ".join(report))
    return worst_abs


def plant_frames(waves: torch.Tensor, starts: torch.Tensor, length: int, noise: float, gen):
    """([B, length] bf16 buffers, the same as an int8 stream carry holds
    them, quantize_int8, and as a float32 one does): noise plus each
    stream's frame at its start."""
    b, t = waves.shape
    buf = noise * torch.randn(b, length, generator=gen, device=waves.device)
    idx = starts.long()[:, None] + torch.arange(t, device=waves.device)
    buf.scatter_add_(1, idx, waves)
    return buf.to(torch.bfloat16), quantize_int8(buf), buf


def quantize_x127(x: torch.Tensor) -> torch.Tensor:
    """Time-major int8 frames [T, B] of float frames [B, T]: round(x.T * 127
    / max|x|), the JAX package's quantized ingest of aligned frames
    (bench.py:388-391)."""
    return torch.round(x.T * (127.0 / x.abs().max())).to(torch.int8).contiguous()


def check_frame(label: str, cfg, x_tm: torch.Tensor, pre: int, rtol: float = RTOL, atol: float = 1e-6) -> float:
    """decide_frame_tm on time-major frames against its plain version:
    words and CRC counts (and so their parities) bit-equal, quality sums
    within ``rtol`` (plus ``atol``). Returns the max absolute error of the
    quality sums."""
    got = kernels.decide_frame_tm(cfg, x_tm, PAYLOAD, preamble_offset=pre)
    want = kernels.decide_frame_tm_ref(cfg, x_tm, PAYLOAD, preamble_offset=pre)
    parity = ((got[1].long() & 1) != (want[1].long() & 1)).sum()
    if int(parity):
        raise AssertionError(f"{label}: crc parity differs in {int(parity)} places")
    return compare(label, got, want, exact=(0, 1), close=(2,), atol=atol, rtol=rtol)


def tm_energies(cfg, x_tm: torch.Tensor, row0: int, n_sym: int,
                basis_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain energies [B, S, M] of n_sym symbols of time-major rows
    [T, B] from row row0: the basis that meets samples of ``basis_dtype``
    (float32 by default; bf16-rounded entries for bfloat16), a float32
    product."""
    sps, m = cfg.samples_per_symbol, cfg.num_tones
    w = x_tm[row0 : row0 + n_sym * sps].float().reshape(n_sym, sps, -1)
    iq = torch.einsum("mk,skb->bsm", kernels._plain_basis(cfg, basis_dtype, x_tm.device).T, w)
    del w
    return iq[..., :m] * iq[..., :m] + iq[..., m:] * iq[..., m:]


def check_frame_split(label: str, cfg, x_tm: torch.Tensor, pre: int) -> float:
    """decide_frame_tm on float32 frames (the three-term split) against its
    plain version with the split's stated tolerance: each symbol's tone,
    read back from the packed words, equal to the plain energies' argmax
    but at near-ties (their two largest energies within split_tol; the
    count printed); words equal but in a tile where a tone parted, CRC
    counts (and so their parities) but in a stream where one did; the best
    and total sums within F32_SPLIT_RTOL of the plain sums (taken in
    float64) plus F32_SPLIT_ATOL of the sum of the symbols' largest
    energies, conf (their ratio, summed) within 2 (F32_SPLIT_RTOL +
    F32_SPLIT_ATOL) of itself. Returns the max absolute error of the
    quality sums."""
    words, crc, qual, s = kernels.decide_frame_tm(cfg, x_tm, PAYLOAD, preamble_offset=pre)
    want = kernels.decide_frame_tm_ref(cfg, x_tm, PAYLOAD, preamble_offset=pre)
    bps, sb = cfg.bits_per_symbol, kernels.TM_SYMBOL_TILE
    place = (sb - 1 - torch.arange(sb, device=x_tm.device)) * bps
    data = ((words.long()[:, None, :] >> place[None, :, None]) & ((1 << bps) - 1)).reshape(-1, words.shape[1])
    tone = (data ^ (data >> 1))[:s].T  # binary -> Gray: the tones [B, S]
    e = tm_energies(cfg, x_tm, pre, s)
    top2 = e.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= split_tol(top2[..., 0], top2[..., 0])
    parted = tone != e.argmax(-1)
    tone_bad = int((parted & ~near).sum())
    tiles = torch.nn.functional.pad(parted, (0, -s % sb)).reshape(parted.shape[0], -1, sb).any(-1).T
    streams = parted.any(1)
    words_bad = int((words != want[0])[~tiles].sum()) + int(data[s:].any())
    crc_bad = int((crc != want[1])[:, ~streams].sum())
    e = e.double()
    best, total = e.amax(-1), e.sum(-1)
    del e, top2
    conf = (best / total.clamp_min(1e-20)).sum(1)
    best, total = best.sum(1), total.sum(1)
    d = [(qual[0] - conf).abs(), (qual[1] - best).abs(), (qual[2] - total).abs()]
    sums_bad = (int((d[0] > 2 * (kernels.F32_SPLIT_RTOL + kernels.F32_SPLIT_ATOL) * conf).sum())
                + int((d[1] > split_tol(best, best)).sum()) + int((d[2] > split_tol(total, best)).sum()))
    worst = max(float(v.max()) for v in d)
    share = float((torch.maximum(d[1], d[2]) / best.clamp_min(1e-30)).max())
    log(f"  {label}: quality sums max abs {worst:.3e}, best/total sums max {share:.3e} of the summed largest "
        f"energies; near-ties {int(near.sum())} of {near.numel()}; tones parted {int(parted.sum())}, off a "
        f"near-tie {tone_bad}; words differing outside those tiles {words_bad}, CRC counts outside those "
        f"streams {crc_bad}; sums beyond the tolerance {sums_bad}")
    if tone_bad or words_bad or crc_bad or sums_bad:
        raise AssertionError(f"{label}: the float32 split route is beyond its tolerance")
    return worst


def phase_kernels(cfg, gen) -> dict:
    """Phase 2: each kernel vs its plain version (256 streams; decide_frame_tm
    also at the full batch, where a block walks many symbol tiles), then
    both timed at the full main-path batch."""
    sps = cfg.samples_per_symbol
    m = cfg.num_tones
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
    pre = cfg.preamble_samples
    chunk = t_frame
    length = _buffer_len(cfg, chunk, PAYLOAD)
    log(f"geometry: frame {t_frame}, data symbols {n_sym}, chunk {chunk}, buffer {length}")
    dev = DEV
    pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
    waves = transmit(cfg, pay, device=DEV)
    tpl = preamble_waveform(cfg, device=DEV).to(torch.bfloat16)
    k = tpl.shape[-1]
    te = float((tpl.float() ** 2).sum())
    results = {}

    # decide_frame_tm at operating noise
    x_f = waves + 0.3 * torch.randn(waves.shape, generator=gen, device=dev)
    x_tm, x8_tm, x32_tm = x_f.to(torch.bfloat16).T.contiguous(), quantize_x127(x_f), x_f.T.contiguous()
    del x_f
    results["decide_frame_tm"] = {"max_abs_err": check_frame("decide_frame_tm", cfg, x_tm, pre)}

    # stream buffers: frames at random starts in the search window, with
    # probe bases st0 = start - 2 at every residue 124..127 mod 128
    starts = torch.randint(3, chunk - 4, (COMPARE_B,), generator=gen, device=dev)
    starts[:8] = torch.tensor([126, 127, 128, 129, 126 + 128 * 100, 127 + 128 * 100,
                               128 + 128 * 200, 129 + 128 * 200], device=dev)
    buf, buf8, _ = plant_frames(waves, starts, length, 0.05, gen)
    seg = buf[:, 1 : 1 + chunk + k - 1]
    got = kernels.sync_search_fused(seg, tpl, chunk, te)
    want = kernels.sync_search_fused_ref(seg, tpl, chunk, te)
    if not torch.equal(got[1], (starts - 1).int()):
        raise AssertionError("sync_search_fused did not find the planted preambles")
    results["sync_search_fused"] = {"max_abs_err": compare("sync_search_fused", got, want, (1,), (0,))}

    # the block maxima of the same search: their maximum is the search's best
    # quality (one rounding of the same product), the winning block its lag's
    bm = kernels.sync_search_blockmax(seg, tpl, chunk, te)
    if not (torch.equal(bm.amax(-1), got[0]) and torch.equal(bm.argmax(-1).int(), got[1] // 128)):
        raise AssertionError("sync_search_blockmax: block maxima disagree with sync_search_fused")
    results["sync_search_blockmax"] = {
        "max_abs_err": compare("sync_search_blockmax", (bm,), (kernels.sync_search_blockmax_ref(seg, tpl, chunk, te),),
                               (), (0,))
    }
    # the template energy as the stream passes it: a float32 scalar on the
    # card, read by both searches through its address, so neither waits for
    # the card
    te_dev = (tpl.float() ** 2).sum()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_dev = kernels.sync_search_fused(seg, tpl, chunk, te_dev)
        bm_dev = kernels.sync_search_blockmax(seg, tpl, chunk, te_dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (torch.equal(got_dev[0], got[0]) and torch.equal(got_dev[1], got[1]) and torch.equal(bm_dev, bm)):
        raise AssertionError("the searches: a template energy on the card gives other bits than a float")
    log("  sync_search_fused, sync_search_blockmax: a template energy on the card, no host read, "
        "bits equal to a float's")

    got = kernels.demod_at_fused(cfg, buf, starts, n_sym)
    want = kernels.demod_at_fused_ref(cfg, buf, starts, n_sym)
    results["demod_at_fused"] = {"max_abs_err": compare("demod_at_fused", got, want, (0,), (1, 2))}

    st0 = starts - 2
    if not {124, 125, 126, 127} <= set((st0 % 128).tolist()):
        raise AssertionError("probe residues 124..127 not covered")
    got = kernels.demod_probe_fused(cfg, buf, st0, n_sym, tpl, n_lags=N_LAGS)
    want = kernels.demod_probe_fused_ref(cfg, buf, st0, n_sym, tpl, n_lags=N_LAGS)
    if not bool((got[1] == 2).all()):
        raise AssertionError("demod_probe_fused servo missed the planted starts")
    results["demod_probe_fused"] = {"max_abs_err": compare("demod_probe_fused", got, want, (1, 3), (0, 2, 4, 5))}

    # the int8 instantiations on the same frames: the aligned batch quantized
    # x127 over its maximum, the stream buffers as an int8 carry holds them
    results["decide_frame_tm:int8"] = {"max_abs_err": check_frame("decide_frame_tm int8", cfg, x8_tm, pre)}
    # and float32 frames, the three-term split
    results["decide_frame_tm:f32"] = {"max_abs_err": check_frame_split("decide_frame_tm float32", cfg, x32_tm, pre)}
    got = kernels.demod_at_fused(cfg, buf8, starts, n_sym)
    want = kernels.demod_at_fused_ref(cfg, buf8, starts, n_sym)
    results["demod_at_fused:int8"] = {"max_abs_err": compare("demod_at_fused int8", got, want, (0,), (1, 2))}
    got = kernels.demod_probe_fused(cfg, buf8, st0, n_sym, tpl, n_lags=N_LAGS)
    want = kernels.demod_probe_fused_ref(cfg, buf8, st0, n_sym, tpl, n_lags=N_LAGS)
    if not bool((got[1] == 2).all()):
        raise AssertionError("demod_probe_fused int8 servo missed the planted starts")
    results["demod_probe_fused:int8"] = {
        "max_abs_err": compare("demod_probe_fused int8", got, want, (1, 3), (0, 2, 4, 5))
    }

    # timings at the full main-path batch (inputs tiled from the subset)
    reps_a, reps_s = ALIGNED_B // COMPARE_B, STREAM_B // COMPARE_B
    x_full, x8_full, x32_full = x_tm.repeat(1, reps_a), x8_tm.repeat(1, reps_a), x32_tm.repeat(1, reps_a)
    buf_full, buf8_full = buf.repeat(reps_s, 1), buf8.repeat(reps_s, 1)
    seg_full = buf_full[:, 1 : 1 + chunk + k - 1]
    st_full, st0_full = starts.repeat(reps_s), st0.repeat(reps_s)
    del x_tm, x8_tm, x32_tm, buf, buf8, waves
    # decide_frame_tm at the full batch: few blocks a column of streams, so
    # each walks many tiles and adds its sums once
    for key, x in (("decide_frame_tm", x_full), ("decide_frame_tm:int8", x8_full)):
        err = check_frame(f"{key} at B = {ALIGNED_B}", cfg, x, pre)
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
    calls = {
        "decide_frame_tm": (
            lambda f: f(cfg, x_full, PAYLOAD, preamble_offset=pre),
            kernels.decide_frame_tm, kernels.decide_frame_tm_ref,
        ),
        "sync_search_fused": (
            lambda f: f(seg_full, tpl, chunk, te),
            kernels.sync_search_fused, kernels.sync_search_fused_ref,
        ),
        "demod_at_fused": (
            lambda f: f(cfg, buf_full, st_full, n_sym),
            kernels.demod_at_fused, kernels.demod_at_fused_ref,
        ),
        "demod_probe_fused": (
            lambda f: f(cfg, buf_full, st0_full, n_sym, tpl, n_lags=N_LAGS),
            kernels.demod_probe_fused, kernels.demod_probe_fused_ref,
        ),
        "sync_search_blockmax": (
            lambda f: f(seg_full, tpl, chunk, te),
            kernels.sync_search_blockmax, kernels.sync_search_blockmax_ref,
        ),
        "decide_frame_tm:int8": (
            lambda f: f(cfg, x8_full, PAYLOAD, preamble_offset=pre),
            kernels.decide_frame_tm, kernels.decide_frame_tm_ref,
        ),
        "demod_at_fused:int8": (
            lambda f: f(cfg, buf8_full, st_full, n_sym),
            kernels.demod_at_fused, kernels.demod_at_fused_ref,
        ),
        "demod_probe_fused:int8": (
            lambda f: f(cfg, buf8_full, st0_full, n_sym, tpl, n_lags=N_LAGS),
            kernels.demod_probe_fused, kernels.demod_probe_fused_ref,
        ),
    }
    # bounds: each input byte read once, each output byte written once
    flops_sym = 2 * sps * 2 * m  # filterbank flops per symbol
    out_sym = 12  # tone i32 + best f32 + total f32 per symbol
    b_a, b_s = ALIGNED_B, STREAM_B
    n_tiles = -(-n_sym // kernels.TM_SYMBOL_TILE)
    pw_e = -(-(k + N_LAGS - 1) // 128) + 1
    lo = torch.minimum(st0_full // 128 * 128, st0_full)
    hi = torch.maximum(st0_full // 128 * 128 + pw_e * 128, st0_full + 2 + pre + n_sym * sps)
    probe_samples = float((hi - lo).sum())
    probe_bytes = probe_samples * 2
    probe_ops = b_s * (2 * N_LAGS * k + 2 * pw_e * 128 + n_sym * flops_sym)
    work = {
        "decide_frame_tm": (n_sym * sps * b_a * 2 + (n_tiles + 64 + 8) * b_a * 4, n_sym * flops_sym * b_a),
        "sync_search_fused": (b_s * (chunk + k - 1) * 2 + 8 * b_s, 2 * k * chunk * b_s),
        "demod_at_fused": (b_s * n_sym * (sps * 2 + out_sym) + 4 * b_s, n_sym * flops_sym * b_s),
        "demod_probe_fused": (probe_bytes + b_s * (16 + n_sym * out_sym), probe_ops),
        "sync_search_blockmax": (b_s * (chunk + k - 1) * 2 + b_s * chunk // 128 * 4, 2 * k * chunk * b_s),
        # int8: one byte a sample, int8 products at the int8 tensor-core peak
        "decide_frame_tm:int8": (
            n_sym * sps * b_a + (n_tiles + 64 + 8) * b_a * 4, n_sym * flops_sym * b_a, INT8_OPS_S,
        ),
        "demod_at_fused:int8": (
            b_s * n_sym * (sps + out_sym) + 4 * b_s, n_sym * flops_sym * b_s, INT8_OPS_S,
        ),
        "demod_probe_fused:int8": (
            probe_samples + b_s * (16 + n_sym * out_sym), probe_ops, INT8_OPS_S,
        ),
    }
    time_and_bound(results, calls, work)
    # the float32 routes at the same shapes, each held against its plain
    # version at the full batch and timed with it: decide_frame_tm's
    # three-term split on float32 frames (check_frame_split); the search's
    # seg and template split into bf16 hi + lo on the tensor cores; the
    # align+demod kernel's three-term split, alone and behind the merged
    # probe (float32 taps on the CUDA cores), held with
    # compare_split_decisions; each split's six products at the bf16 peak
    err = check_frame_split(f"decide_frame_tm float32 at B = {b_a}", cfg, x32_full, pre)
    results["decide_frame_tm:f32"]["max_abs_err"] = max(results["decide_frame_tm:f32"]["max_abs_err"], err)
    time_f32_route(results, "decide_frame_tm", lambda f: f(cfg, x32_full, PAYLOAD, preamble_offset=pre),
                   n_sym * sps * b_a * 4 + (n_tiles + 64 + 8) * b_a * 4,
                   F32_SPLIT_PRODUCTS * n_sym * flops_sym * b_a, BF16_FLOPS_S)
    del x32_full, x_full, x8_full
    torch.cuda.empty_cache()
    buf32, tpl32 = buf_full.float(), preamble_waveform(cfg, device=DEV)
    seg32, te32 = buf32[:, 1 : 1 + chunk + k - 1], float((tpl32**2).sum())
    got = kernels.sync_search_fused(seg32, tpl32, chunk, te32)
    if not torch.equal(got[1], (st_full - 1).int()):
        raise AssertionError("sync_search_fused float32 did not find the planted preambles")
    results["sync_search_fused:f32"] = {"max_abs_err": compare(
        "sync_search_fused float32", got, kernels.sync_search_fused_ref(seg32, tpl32, chunk, te32), (1,), (0,))}
    bm32 = kernels.sync_search_blockmax(seg32, tpl32, chunk, te32)
    if not (torch.equal(bm32.amax(-1), got[0]) and torch.equal(bm32.argmax(-1).int(), got[1] // 128)):
        raise AssertionError("sync_search_blockmax float32: block maxima disagree with sync_search_fused")
    results["sync_search_blockmax:f32"] = {"max_abs_err": compare(
        "sync_search_blockmax float32", (bm32,), (kernels.sync_search_blockmax_ref(seg32, tpl32, chunk, te32),),
        (), (0,))}
    del bm32
    time_f32_route(results, "sync_search_fused", lambda f: f(seg32, tpl32, chunk, te32),
                   b_s * (chunk + k - 1) * 4 + 8 * b_s, 2 * k * chunk * b_s, BF16_FLOPS_S)
    time_f32_route(results, "sync_search_blockmax", lambda f: f(seg32, tpl32, chunk, te32),
                   b_s * (chunk + k - 1) * 4 + b_s * chunk // 128 * 4, 2 * k * chunk * b_s, BF16_FLOPS_S)
    got = kernels.demod_at_fused(cfg, buf32, st_full, n_sym)
    want = kernels.demod_at_energies_fused_ref(cfg, buf32, st_full, n_sym)
    results["demod_at_fused:f32"] = {
        "max_abs_err": compare_split_decisions(f"demod_at_fused float32 at B = {b_s}", got, want)}
    del got, want
    demod_split_ops = F32_SPLIT_PRODUCTS * n_sym * flops_sym * b_s
    time_f32_route(results, "demod_at_fused", lambda f: f(cfg, buf32, st_full, n_sym),
                   b_s * n_sym * (sps * 4 + out_sym) + 4 * b_s, demod_split_ops, BF16_FLOPS_S)
    got = kernels.demod_probe_fused(cfg, buf32, st0_full, n_sym, tpl32, n_lags=N_LAGS)
    want = kernels.demod_probe_fused_ref(cfg, buf32, st0_full, n_sym, tpl32, n_lags=N_LAGS)
    if not bool((got[1] == 2).all()):
        raise AssertionError("demod_probe_fused float32 servo missed the planted starts")
    err = compare("demod_probe_fused float32 probe", got[:3], want[:3], (1,), (0, 2))
    want = kernels.demod_at_energies_fused_ref(cfg, buf32, st0_full + want[1], n_sym)
    err = max(err, compare_split_decisions(f"demod_probe_fused float32 demod at B = {b_s}", got[3:], want))
    results["demod_probe_fused:f32"] = {"max_abs_err": err}
    del got, want
    # the probe's float32 multiply-adds on the CUDA cores, counted at the
    # bf16 peak as their time there, plus the demod's six split products
    probe_f32_ops = probe_ops - b_s * n_sym * flops_sym
    time_f32_route(results, "demod_probe_fused", lambda f: f(cfg, buf32, st0_full, n_sym, tpl32, n_lags=N_LAGS),
                   probe_samples * 4 + b_s * (16 + n_sym * out_sym),
                   probe_f32_ops * (BF16_FLOPS_S / F32_FLOPS_S) + demod_split_ops, BF16_FLOPS_S)
    del buf32, seg32
    torch.cuda.empty_cache()
    return results


def phase_kernels_coded(cfg, gen) -> dict:
    """Phase 2 for the coded paths' kernels (mfsk4-coded geometry)."""
    sps, m = cfg.samples_per_symbol, cfg.num_tones
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
    n_data = 8 * tframe.data_section_bytes(PAYLOAD)
    t_steps = n_data + fec.CONV_TAIL_BITS
    chunk = t_frame
    length = _buffer_len(cfg, chunk, PAYLOAD)
    log(f"coded geometry: frame {t_frame}, data symbols {n_sym}, air bits "
        f"{tframe.data_section_coded_bits(cfg, PAYLOAD)}, trellis steps {t_steps}, chunk {chunk}, "
        f"buffer {length}")
    if (t_frame, n_sym, t_steps, length) != (70144, 2160, 2150, 143872):
        raise AssertionError("mfsk4-coded geometry differs from the reference's")
    pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    waves = transmit(cfg, pay, device=DEV)
    tpl = preamble_waveform(cfg, device=DEV).to(torch.bfloat16)
    k = tpl.shape[-1]
    te = float((tpl.float() ** 2).sum())
    results = {}

    # stream buffers at operating noise, probe bases st0 = start - 2 at every
    # residue 124..127 mod 128
    starts = torch.randint(3, chunk - 4, (COMPARE_B,), generator=gen, device=DEV)
    starts[:8] = torch.tensor([126, 127, 128, 129, 126 + 128 * 100, 127 + 128 * 100,
                               128 + 128 * 200, 129 + 128 * 200], device=DEV)
    buf, buf8, buf32 = plant_frames(waves, starts, length, 0.3, gen)
    st0 = starts - 2
    if not {124, 125, 126, 127} <= set((st0 % 128).tolist()):
        raise AssertionError("probe residues 124..127 not covered")
    got = kernels.probe_at_fused(buf, st0, tpl, te, n_lags=N_LAGS)
    want = kernels.probe_at_fused_ref(buf, st0, tpl, te, n_lags=N_LAGS)
    if not bool((got.argmax(-1) == 2).all()):
        raise AssertionError("probe_at_fused missed the planted starts")
    results["probe_at_fused"] = {"max_abs_err": compare("probe_at_fused", (got,), (want,), (), (0,))}
    # the template energy as the locked step passes it: a float32 scalar on
    # the card, read by the kernel through its address
    te_dev = (tpl.float() ** 2).sum()
    if not torch.equal(kernels.probe_at_fused(buf, st0, tpl, te_dev, n_lags=N_LAGS), got):
        raise AssertionError("probe_at_fused: a template energy on the card gives other bits than a float")

    # the search kernel again, at this path's geometry (its row in the table
    # keeps the uncoded geometry's numbers)
    seg = buf[:, 1 : 1 + chunk + k - 1]
    got = kernels.sync_search_fused(seg, tpl, chunk, te)
    want = kernels.sync_search_fused_ref(seg, tpl, chunk, te)
    if not torch.equal(got[1], (starts - 1).int()):
        raise AssertionError("sync_search_fused did not find the planted coded preambles")
    compare("sync_search_fused (coded geometry)", got, want, (1,), (0,))

    got = kernels.demod_at_energies_fused(cfg, buf, starts, n_sym)
    want = kernels.demod_at_energies_fused_ref(cfg, buf, starts, n_sym)
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError("demod_at_energies_fused: winning tones differ")
    results["demod_at_energies_fused"] = {
        "max_abs_err": compare("demod_at_energies_fused", (got,), (want,), (), (0,))
    }
    got8 = kernels.demod_at_energies_fused(cfg, buf8, starts, n_sym)
    want8 = kernels.demod_at_energies_fused_ref(cfg, buf8, starts, n_sym)
    if not torch.equal(got8.argmax(-1), want8.argmax(-1)):
        raise AssertionError("demod_at_energies_fused int8: winning tones differ")
    results["demod_at_energies_fused:int8"] = {
        "max_abs_err": compare("demod_at_energies_fused int8", (got8,), (want8,), (), (0,))
    }
    del got8, want8

    # the trellis on the LLRs of those noisy coded frames: bits compared exactly
    rx = trellis_llrs(cfg, got, t_steps)
    signs = torch.as_tensor(fec._branch_signs(), device=DEV)
    got_bits = kernels.viterbi_trellis(signs, rx)
    want_bits = kernels.viterbi_trellis_ref(signs, rx)
    sent = tframe.data_section_air_bits_array(dataclasses.replace(cfg, fec="none"), pay)
    if not torch.equal(got_bits[:, :n_data], sent) or bool(got_bits[:, n_data:].any()):
        raise AssertionError("viterbi_trellis did not decode the sent data sections")
    compare("viterbi_trellis", (got_bits,), (want_bits,), (0,), ())
    results["viterbi_trellis"] = {"max_abs_err": float((got_bits.int() - want_bits.int()).abs().max())}
    # the variable-length coded parse's other two trellises: the max-length
    # one with the LLRs past a shorter frame zeroed (exact ties from there on)
    # and the 102-step unflushed header probe; every bit equal
    masked = rx.clone()
    masked[:, t_steps // 3 :] = 0.0
    probe = rx[:, : fec.conv_encoded_bits(tframe.HEADER_PROBE_DATA_BITS) // 2].contiguous()
    for label, x in (("masked tail", masked), ("header probe", probe)):
        compare(f"viterbi_trellis ({label}, {x.shape[1]} steps)", (kernels.viterbi_trellis(signs, x),),
                (kernels.viterbi_trellis_ref(signs, x),), (0,), ())
    del masked, probe

    # the float32 route (the three-term split on the tensor cores) on the
    # float32 buffers of the same frames, to the split's tolerance; the
    # trellis on its LLRs gives the bits of the plain energies' LLRs, and
    # every frame's payload and verdicts are the plain energies' and right
    got32 = kernels.demod_at_energies_fused(cfg, buf32, starts, n_sym)
    want32 = kernels.demod_at_energies_fused_ref(cfg, buf32, starts, n_sym)
    results["demod_at_energies_fused:f32"] = {
        "max_abs_err": compare_split_energies("demod_at_energies_fused float32", got32, want32)}
    bits32 = [kernels.viterbi_trellis(signs, trellis_llrs(cfg, e, t_steps)) for e in (got32, want32)]
    if not torch.equal(*bits32) or not torch.equal(bits32[0][:, :n_data], sent):
        raise AssertionError("viterbi_trellis on the float32 split energies: bits differ from the plain "
                             "energies' or from the sent data sections")
    frames32 = [tframe.frame_result_from_decisions(cfg, decide_symbols(cfg, e), e, PAYLOAD) for e in (got32, want32)]
    if not same_verdicts(*frames32) or not bool(frames32[0].ok.all()) or not torch.equal(frames32[0].payload, pay):
        raise AssertionError("demod_at_energies_fused float32: payloads or verdicts differ from the plain "
                             "energies' or from what was sent")
    log(f"  demod_at_energies_fused float32 -> LLRs -> viterbi_trellis: bits equal to the plain energies' "
        f"({bits32[0].numel()} bits), {COMPARE_B} frames ok, payloads and verdicts equal")
    del got32, want32, bits32, frames32

    reps = STREAM_B // COMPARE_B
    buf_full, st_full, st0_full = buf.repeat(reps, 1), starts.repeat(reps), st0.repeat(reps)
    buf8_full = buf8.repeat(reps, 1)
    rx_full = rx.repeat(reps, 1, 1)
    del buf, buf8, waves, got, want
    calls = {
        "probe_at_fused": (
            lambda f: f(buf_full, st0_full, tpl, te, n_lags=N_LAGS),
            kernels.probe_at_fused, kernels.probe_at_fused_ref,
        ),
        "demod_at_energies_fused": (
            lambda f: f(cfg, buf_full, st_full, n_sym),
            kernels.demod_at_energies_fused, kernels.demod_at_energies_fused_ref,
        ),
        "demod_at_energies_fused:int8": (
            lambda f: f(cfg, buf8_full, st_full, n_sym),
            kernels.demod_at_energies_fused, kernels.demod_at_energies_fused_ref,
        ),
        "viterbi_trellis": (
            lambda f: f(signs, rx_full), kernels.viterbi_trellis, kernels.viterbi_trellis_ref,
        ),
    }
    b = STREAM_B
    pw_e = -(-(k + N_LAGS - 1) // 128) + 1
    # add-compare-select of one state and step: 4 multiplies, 4 adds, a
    # compare and a select, on the CUDA cores (no tensor-core form exists)
    acs_ops = 10 * kernels.VIT_STATES
    work = {
        "probe_at_fused": (
            b * (pw_e * 128 * 2 + 4 + N_LAGS * 4) + k * 4, b * (2 * N_LAGS * k + 2 * pw_e * 128),
        ),
        "demod_at_energies_fused": (
            b * (n_sym * (sps * 2 + m * 4) + 4), b * n_sym * 2 * sps * 2 * m,
        ),
        "demod_at_energies_fused:int8": (
            b * (n_sym * (sps + m * 4) + 4), b * n_sym * 2 * sps * 2 * m, INT8_OPS_S,
        ),
        "viterbi_trellis": (b * t_steps * (8 + 1) + 64 * 4 * 4, b * t_steps * acs_ops, F32_FLOPS_S),
    }
    time_and_bound(results, calls, work)
    ms = time_ms(lambda: kernels.probe_at_fused(buf_full, st0_full, tpl, te_dev, n_lags=N_LAGS))
    log(f"  probe_at_fused (template energy on the card, as the locked step passes it: B {b}): "
        f"kernel {ms:.3f} ms, bound {results['probe_at_fused']['bound_ms']:.3f} ms")
    log_search_time("coded geometry", buf_full[:, 1 : 1 + chunk + k - 1], tpl, chunk)
    # the float32 route at the full batch: held to the split's tolerance,
    # timed against its bound (bytes, or its six products at the bf16 peak)
    buf32_full = buf32.repeat(reps, 1)
    del buf32
    results["demod_at_energies_fused:f32"]["max_abs_err"] = max(
        results["demod_at_energies_fused:f32"]["max_abs_err"],
        compare_split_energies(f"demod_at_energies_fused float32 at B = {b}",
                               kernels.demod_at_energies_fused(cfg, buf32_full, st_full, n_sym),
                               kernels.demod_at_energies_fused_ref(cfg, buf32_full, st_full, n_sym)))
    time_f32_route(results, "demod_at_energies_fused", lambda f: f(cfg, buf32_full, st_full, n_sym),
                   b * (n_sym * (sps * 4 + m * 4) + 4), F32_SPLIT_PRODUCTS * b * n_sym * 2 * sps * 2 * m,
                   BF16_FLOPS_S)
    del buf32_full
    torch.cuda.empty_cache()
    return results


def trellis_llrs(cfg, energies: torch.Tensor, t_steps: int) -> torch.Tensor:
    """The trellis input [B, t_steps, 2] of the coded receiver from the
    filterbank energies [B, S, M]: the max-log LLRs of the data section's
    air bits, deinterleaved."""
    air = bit_llrs(cfg, energies)[..., : tframe.data_section_coded_bits(cfg, PAYLOAD)]
    rx = fec.deinterleave(air, cfg.fec_interleave, 2 * t_steps)
    return rx.reshape(energies.shape[0], t_steps, 2).contiguous()


def split_tol(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The three-term split's stated tolerance: F32_SPLIT_RTOL of the plain
    value plus F32_SPLIT_ATOL of its symbol's largest plain energy."""
    return kernels.F32_SPLIT_RTOL * w.abs() + kernels.F32_SPLIT_ATOL * scale


def compare_split(label: str, cfg, x: torch.Tensor, route: str = "split") -> float:
    """tone_energies_fused and decide_tones_fused with float32 compute (the
    three-term split on the tensor cores: ``route`` "split", the
    compile-time walk, or "any_split", filterbank_any.cu's) on rows ``x``
    against their plain versions, with the route's stated tolerance: each
    energy within split_tol of the plain one, the energies' argmax equal
    but at near-ties, the decisions as compare_split_decisions holds them.
    Returns the max absolute error."""
    if kernels._filterbank_operands("tone_energies", cfg, torch.float32, DEV)[1] != route:
        raise AssertionError(f"{label}: float32 compute does not take the {route} route")
    want = kernels.tone_energies_fused_ref(cfg, x, compute_dtype=torch.float32)
    worst = compare_split_energies(label, kernels.tone_energies_fused(cfg, x, compute_dtype=torch.float32), want)
    decisions = kernels.decide_tones_fused(cfg, x, compute_dtype=torch.float32)
    return max(worst, compare_split_decisions(f"{label}, decisions", decisions, want))


def compare_split_energies(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Energies [..., S, M] of the three-term split on the tensor cores
    against the plain ones ``want`` of the same symbols: each within
    split_tol of the plain one (F32_SPLIT_RTOL of itself plus
    F32_SPLIT_ATOL of its symbol's largest), the argmax equal but at
    near-ties. Returns the max absolute error."""
    scale = want.amax(-1)
    diff = (got - want).abs()
    worst = float(diff.max())
    bad = int((diff > split_tol(want, scale[..., None])).sum())
    worst_scaled = float((diff / scale[..., None].clamp_min(1e-30)).max())
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= split_tol(top2[..., 0], top2[..., 0])
    argmax_bad = int(((got.argmax(-1).int() != want.argmax(-1).int()) & ~near).sum())
    del diff, top2, near
    log(f"  {label}: energies max abs {worst:.3e}, max {worst_scaled:.3e} of the symbol's largest, beyond "
        f"the tolerance {bad}; energies' argmax differing off a near-tie {argmax_bad}")
    if bad or argmax_bad:
        raise AssertionError(f"{label}: the float32 split route is beyond its tolerance")
    return worst


def compare_split_decisions(label: str, got, want: torch.Tensor) -> float:
    """Decisions (tone, best, total) of the three-term split on the tensor
    cores against the plain energies ``want`` [..., S, M] of the same
    symbols: best and total within split_tol, tones equal but where the
    plain version's two largest energies lie that close (their count
    printed). Logs the largest error as a share of the symbol's largest
    energy. Returns the max absolute error."""
    tone, best, total = got
    scale, total_w = want.amax(-1), want.sum(-1)
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= split_tol(top2[..., 0], top2[..., 0])
    tone_bad = int(((tone != want.argmax(-1).int()) & ~near).sum())
    del top2
    d_best, d_total = (best - scale).abs(), (total - total_w).abs()
    best_bad = int((d_best > split_tol(scale, scale)).sum())
    total_bad = int((d_total > split_tol(total_w, scale)).sum())
    worst = max(float(d_best.max()), float(d_total.max()))
    share = float((torch.maximum(d_best, d_total) / scale.clamp_min(1e-30)).max())
    log(f"  {label}: best/total max abs {worst:.3e}, max {share:.3e} of the symbol's largest energy; "
        f"near-ties {int(near.sum())} of {near.numel()}; tones differing off a near-tie {tone_bad}; "
        f"best beyond the tolerance {best_bad}, total beyond {total_bad}")
    if tone_bad or best_bad or total_bad:
        raise AssertionError(f"{label}: the float32 split route is beyond its tolerance")
    return worst


def phase_kernels_batch_major(cfg, gen) -> dict:
    """Phase 2 for the batch-major filterbank (mfsk16-fast): frames at
    operating noise, their data sections read in place past the preamble.
    bfloat16 compute (the tensor-core route, bf16 rows) held against the
    plain versions at 256 rows and at B = 16,384 (tones bit-equal) and
    timed there; then the float32-compute route (the three-term split,
    receive_frame's default) on bf16 rows and on float32 rows held against
    the plain versions with its tolerance (compare_split) at 256 rows and
    at B = 16,384 and timed there against its bound (bytes, or its 3 or 6
    products at the bf16 peak): the "<name>:f32" results, float32 rows,
    with the bf16 rows' numbers under "bf16_rows"."""
    sps, m = cfg.samples_per_symbol, cfg.num_tones
    n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
    pre = cfg.preamble_samples
    pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    w = transmit(cfg, pay, device=DEV)
    xf = w + 0.3 * torch.randn(w.shape, generator=gen, device=DEV)
    x = xf.to(torch.bfloat16)
    data_full = x.repeat(ALIGNED_B // COMPARE_B, 1)[:, pre:]
    del w
    results = {"tone_energies_fused": {"max_abs_err": 0.0}, "decide_tones_fused": {"max_abs_err": 0.0}}
    for data in (x[:, pre:], data_full):
        b = data.shape[0]
        got = kernels.tone_energies_fused(cfg, data, compute_dtype=torch.bfloat16)
        want = kernels.tone_energies_fused_ref(cfg, data, compute_dtype=torch.bfloat16)
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"tone_energies_fused (B {b}): winning tones differ")
        err = compare(f"tone_energies_fused (B {b})", (got,), (want,), (), (0,))
        results["tone_energies_fused"]["max_abs_err"] = max(results["tone_energies_fused"]["max_abs_err"], err)
        del got, want
        got = kernels.decide_tones_fused(cfg, data, compute_dtype=torch.bfloat16)
        want = kernels.decide_tones_fused_ref(cfg, data, compute_dtype=torch.bfloat16)
        err = compare(f"decide_tones_fused (B {b})", got, want, (0,), (1, 2))
        results["decide_tones_fused"]["max_abs_err"] = max(results["decide_tones_fused"]["max_abs_err"], err)
        del got, want
        torch.cuda.empty_cache()
    calls = {
        "tone_energies_fused": (
            lambda f: f(cfg, data_full, compute_dtype=torch.bfloat16),
            kernels.tone_energies_fused, kernels.tone_energies_fused_ref,
        ),
        "decide_tones_fused": (
            lambda f: f(cfg, data_full, compute_dtype=torch.bfloat16),
            kernels.decide_tones_fused, kernels.decide_tones_fused_ref,
        ),
    }
    b, flops = ALIGNED_B, n_sym * 2 * sps * 2 * m * ALIGNED_B
    out_bytes = {"tone_energies_fused": m * 4, "decide_tones_fused": 12}
    work = {name: (b * n_sym * (sps * 2 + o), flops) for name, o in out_bytes.items()}
    time_and_bound(results, calls, work)
    # the float32-compute route: bf16 rows (the one-shot receiver's) and
    # float32 rows (transmit's and apply_channel's), 3 and 6 products
    err = 0.0
    for label, rows in (("bf16 rows", x), ("float32 rows", xf)):
        err = max(err, compare_split(f"float32 compute, {label}, B {COMPARE_B}", cfg, rows[:, pre:]))
    data32 = xf.repeat(ALIGNED_B // COMPARE_B, 1)[:, pre:]
    del x, xf
    for label, data, n_products in (("bf16 rows", data_full, 3), ("float32 rows", data32, 6)):
        err = max(err, compare_split(f"float32 compute, {label}, B {b}", cfg, data))
        torch.cuda.empty_cache()
        for name, fn, ref in (("tone_energies_fused", kernels.tone_energies_fused, kernels.tone_energies_fused_ref),
                              ("decide_tones_fused", kernels.decide_tones_fused, kernels.decide_tones_fused_ref)):
            r = {"max_abs_err": err, "ms": time_ms(lambda: fn(cfg, data, compute_dtype=torch.float32)),
                 "plain_ms": time_ms(lambda: ref(cfg, data, compute_dtype=torch.float32))}
            r["bound_ms"], r["bound_by"] = bound_ms(b * n_sym * (sps * data.element_size() + out_bytes[name]),
                                                    n_products * flops)
            log(f"  {name} (float32 compute, {label}: B {b}, {n_sym} symbols): kernel {r['ms']:.3f} ms, "
                f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
            if label == "bf16 rows":
                results[f"{name}:f32"] = {"bf16_rows": r}
            else:
                results[f"{name}:f32"].update(r, max_abs_err=err)
            torch.cuda.empty_cache()
    return results


def top_two_lags(seg, corr, k: int, te: float, t_short: int):
    """The two candidates the multi-candidate step would take from ``corr``:
    the best-quality lag and, with that frame's extent masked, the next."""
    q = tsync.blockwise_match_quality(seg, corr, k, te)
    first = q.argmax(-1)
    lag = torch.arange(q.shape[-1], device=q.device)
    covered = (lag >= first[:, None]) & (lag < first[:, None] + t_short)
    return first, q.masked_fill(covered, float("-inf")).argmax(-1)


def phase_kernels_dynamic(cfg, gen) -> dict:
    """Phase 2 for the kernels of the variable-length, oversized-window and
    one-shot paths (mfsk16-fast, max payload 256, shortest payload 64)."""
    sps, m = cfg.samples_per_symbol, cfg.num_tones
    pre = cfg.preamble_samples
    t_max = tframe.frame_num_samples(cfg, PAYLOAD)
    t_short = tframe.frame_num_samples(cfg, SHORT_PAYLOAD)
    chunk = 2 * t_short
    length = _buffer_len(cfg, t_max, PAYLOAD)
    log(f"dynamic geometry: max frame {t_max}, shortest frame {t_short}, chunk {chunk}, buffer {length}")
    if (t_max, t_short, chunk, length) != (36352, 11776, 23552, 76288):
        raise AssertionError("mfsk16-fast dynamic geometry differs from the reference's")
    tpl = preamble_waveform(cfg, device=DEV).to(torch.bfloat16)
    k = tpl.shape[-1]
    te = float((tpl.float() ** 2).sum())
    results = {}

    # correlate_fused: two back-to-back shortest frames a segment, the
    # multi-candidate step's case; every lag within RTOL of the output's
    # scale (the sums cancel, so small lags have no relative precision) and
    # the two candidates drawn from it equal
    pay = torch.randint(0, 256, (COMPARE_B, SHORT_PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    waves = transmit(cfg, pay, device=DEV)
    n_seg = chunk + k - 1
    first = torch.randint(1, 5000, (COMPARE_B,), generator=gen, device=DEV)
    seg = 0.05 * torch.randn(COMPARE_B, n_seg + t_short, generator=gen, device=DEV)
    idx = first[:, None] + torch.arange(t_short, device=DEV)
    seg.scatter_add_(1, idx, waves)
    seg.scatter_add_(1, idx + t_short, waves)
    seg = seg[:, :n_seg].to(torch.bfloat16)
    got = kernels.correlate_fused(seg, tpl, chunk)
    want = kernels.correlate_fused_ref(seg, tpl, chunk)
    scale = float(want.square().mean().sqrt())
    results["correlate_fused"] = {
        "max_abs_err": compare("correlate_fused", (got,), (want,), (), (0,), atol=RTOL * scale)
    }
    # its float32 route: segment and template split into bf16 hi + lo
    got32 = kernels.correlate_fused(seg.float(), tpl.float(), chunk)
    results["correlate_fused:f32"] = {"max_abs_err": compare(
        "correlate_fused float32", (got32,), (kernels.correlate_fused_ref(seg.float(), tpl.float(), chunk),),
        (), (0,), atol=RTOL * scale)}
    del got32
    picks_got, picks_want = top_two_lags(seg, got, k, te, t_short), top_two_lags(seg, want, k, te, t_short)
    if not (torch.equal(picks_got[0], picks_want[0]) and torch.equal(picks_got[1], picks_want[1])
            and torch.equal(torch.minimum(*picks_got), first)
            and torch.equal(torch.maximum(*picks_got), first + t_short)):
        raise AssertionError("correlate_fused: the two candidates differ from the plain version's or the planted starts")

    # decide_tones_tm: frames at operating noise followed by 8 symbols of noise
    pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    frames = torch.nn.functional.pad(transmit(cfg, pay, device=DEV), (0, 8 * sps))
    x32_tm = (frames + 0.3 * torch.randn(frames.shape, generator=gen, device=DEV)).T.contiguous()
    data32_tm = x32_tm[pre:]
    data_tm = data32_tm.to(torch.bfloat16)
    got = kernels.decide_tones_tm(cfg, data_tm)
    want = kernels.decide_tones_tm_ref(cfg, data_tm)
    results["decide_tones_tm"] = {"max_abs_err": compare("decide_tones_tm", got, want, (0,), (1, 2))}
    n_sym = data_tm.shape[0] // sps
    # bf16 rows off 16 bytes; the float32 route (the three-term split) on
    # the float32 frames, and off 16 bytes (B - 1)
    x = data_tm[:, 1:].contiguous()
    compare("decide_tones_tm (bfloat16, B - 1)", kernels.decide_tones_tm(cfg, x), kernels.decide_tones_tm_ref(cfg, x),
            (0,), (1, 2))
    results["decide_tones_tm:f32"] = {"max_abs_err": max(
        compare_split_decisions(f"decide_tones_tm ({label})", [v.T for v in kernels.decide_tones_tm(cfg, x)],
                                tm_energies(cfg, x, 0, n_sym))
        for label, x in (("float32", data32_tm), ("float32, B - 1", data32_tm[:, 1:].contiguous())))}

    # gather_rows_fused: one frame out of the stream buffer, starts on both
    # sides of the 128-sample rows the reference kernel splits at and at
    # every byte residue mod 16 of an int8 row (rows are whole 16 bytes)
    buf = torch.randn(COMPARE_B, length, generator=gen, device=DEV).to(torch.bfloat16)
    starts = torch.randint(0, length - t_max + 1, (COMPARE_B,), generator=gen, device=DEV)
    starts[:6] = torch.tensor([0, 1, 63, 127, 128 * 9 + 127, length - t_max], device=DEV)
    starts[6:22] = 128 * 3 + torch.arange(16, device=DEV)
    if not {0, 1, 63, 127} <= set((starts % 128).tolist()):
        raise AssertionError("gather residues 0, 1, 63, 127 not covered")
    got = kernels.gather_rows_fused(buf, starts, t_max)
    want = kernels.gather_rows_fused_ref(buf, starts, t_max)
    compare("gather_rows_fused", (got.view(torch.int16),), (want.view(torch.int16),), (0,), ())
    results["gather_rows_fused"] = {"max_abs_err": float((got.float() - want.float()).abs().max())}
    buf8 = quantize_int8(buf.float())  # as an int8 carry holds the samples
    for label, b_ in (("int8", buf8), ("float32", buf.float())):
        e = b_.element_size()
        if set(((starts * e) % 16).tolist()) != set(range(0, 16, e)) or length * e % 16:
            raise AssertionError(f"gather ({label}): the starts miss a byte residue mod 16")
        got = kernels.gather_rows_fused(b_, starts, t_max)
        want = kernels.gather_rows_fused_ref(b_, starts, t_max)
        compare(f"gather_rows_fused ({label})", (got.view(torch.uint8),), (want.view(torch.uint8),), (0,), ())
        if label == "int8":
            results["gather_rows_fused:int8"] = {"max_abs_err": float((got.float() - want.float()).abs().max())}

    reps_a, reps_s = ALIGNED_B // COMPARE_B, STREAM_B // COMPARE_B
    seg_full = seg.repeat(reps_s, 1)
    data_full = data_tm.repeat(1, reps_a)
    data32_full = data32_tm.repeat(1, reps_a)
    buf_full, st_full = buf.repeat(reps_s, 1), starts.repeat(reps_s)
    buf8_full = buf8.repeat(reps_s, 1)
    del seg, x32_tm, data32_tm, data_tm, buf, buf8, b_, frames, waves, got, want
    calls = {
        "correlate_fused": (
            lambda f: f(seg_full, tpl, chunk), kernels.correlate_fused, kernels.correlate_fused_ref,
        ),
        "decide_tones_tm": (
            lambda f: f(cfg, data_full), kernels.decide_tones_tm, kernels.decide_tones_tm_ref,
        ),
        "gather_rows_fused": (
            lambda f: f(buf_full, st_full, t_max), kernels.gather_rows_fused, kernels.gather_rows_fused_ref,
        ),
        "gather_rows_fused:int8": (
            lambda f: f(buf8_full, st_full, t_max), kernels.gather_rows_fused, kernels.gather_rows_fused_ref,
        ),
    }
    b_a, b_s = ALIGNED_B, STREAM_B
    work = {
        "correlate_fused": (b_s * (n_seg * 2 + chunk * 4) + k * 4, 2 * k * chunk * b_s),
        "decide_tones_tm": (b_a * n_sym * (sps * 2 + 12), n_sym * 2 * sps * 2 * m * b_a),
        "gather_rows_fused": (b_s * (2 * t_max * 2 + 4), 0),
        "gather_rows_fused:int8": (b_s * (2 * t_max + 4), 0),
    }
    # the one PyTorch call computing the same function: a float32 convolution
    # (cuDNN, TF32 off) and an index gather; decide_tones_tm has none
    seg_f32 = seg_full.float()[:, None, :]
    weight = tpl.float()[None, None, :]
    gather_idx = st_full[:, None] + torch.arange(t_max, device=DEV)
    library = {
        "correlate_fused": lambda: torch.nn.functional.conv1d(seg_f32, weight),
        "gather_rows_fused": lambda: torch.gather(buf_full, 1, gather_idx),
        "gather_rows_fused:int8": lambda: torch.gather(buf8_full, 1, gather_idx),
    }
    lib_corr = torch.nn.functional.conv1d(seg_f32[:COMPARE_B], weight)[:, 0]
    if not torch.allclose(lib_corr, kernels.correlate_fused(seg_full[:COMPARE_B], tpl, chunk), rtol=RTOL, atol=RTOL * scale):
        raise AssertionError("conv1d does not compute correlate_fused's function")
    del lib_corr
    time_and_bound(results, calls, work, library)
    del buf8_full
    # decide_tones_tm's float32 route (the three-term split) at the full
    # batch, with its plain version, its six products at the bf16 peak;
    # then the other routes of the two, each against its bound:
    # decide_tones_tm on bf16 rows off 16 bytes, the float32 gather
    err = compare_split_decisions(f"decide_tones_tm (float32, B {b_a})",
                                  [v.T for v in kernels.decide_tones_tm(cfg, data32_full)],
                                  tm_energies(cfg, data32_full, 0, n_sym))
    results["decide_tones_tm:f32"]["max_abs_err"] = max(results["decide_tones_tm:f32"]["max_abs_err"], err)
    torch.cuda.empty_cache()
    time_f32_route(results, "decide_tones_tm", lambda f: f(cfg, data32_full), b_a * n_sym * (sps * 4 + 12),
                   F32_SPLIT_PRODUCTS * n_sym * 2 * sps * 2 * m * b_a, BF16_FLOPS_S)
    del data32_full
    other_routes = {
        f"decide_tones_tm (bfloat16, B {b_a - 1})": (
            lambda x: kernels.decide_tones_tm(cfg, x), lambda: data_full[:, 1:].contiguous(),
            (b_a - 1) * n_sym * (sps * 2 + 12), n_sym * 2 * sps * 2 * m * (b_a - 1), BF16_FLOPS_S),
        "gather_rows_fused (float32)": (
            lambda x: kernels.gather_rows_fused(x, st_full, t_max), lambda: buf_full.float(),
            b_s * (2 * t_max * 4 + 4), 0, BF16_FLOPS_S),
    }
    for label, (fn, make, n_bytes, n_ops, peak) in other_routes.items():
        x = make()
        ms = time_ms(lambda: fn(x))
        bound, by = bound_ms(n_bytes, n_ops, peak)
        log(f"  {label}: kernel {ms:.3f} ms, bound {bound:.3f} ms ({by})")
        del x
        torch.cuda.empty_cache()
    # correlate_fused's float32 routes (bf16 hi + lo: two and three products)
    log_search_time("main shape", seg_full, tpl.float(), chunk, name="correlate_fused")
    seg32, tpl32 = seg_full.float(), tpl.float()
    time_f32_route(results, "correlate_fused", lambda f: f(seg32, tpl32, chunk),
                   b_s * (n_seg * 4 + chunk * 4) + k * 4, 2 * k * chunk * b_s, BF16_FLOPS_S)
    del seg32

    # the variable-length parse behind the kernels, per chunk of 8,192 streams
    # (CUDA events, median of 5): the whole parse, and its per-length CRC alone
    n_sym_max = tframe.data_symbols_for_payload(cfg, PAYLOAD)
    tone = torch.randint(0, m, (b_s, n_sym_max), generator=gen, device=DEV, dtype=torch.int32)
    best = torch.rand(b_s, n_sym_max, generator=gen, device=DEV) + 1.0
    body = torch.randint(0, 256, (b_s, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    plen = torch.randint(0, PAYLOAD + 1, (b_s,), generator=gen, device=DEV)
    parse = time_ms(lambda: tframe.dynamic_frame_result_from_tone_decisions(cfg, tone, best, best * 1.5, PAYLOAD))
    crc = time_ms(lambda: fec.crc32_device(body, length=plen))
    log(f"  dynamic parse (B {b_s}, {n_sym_max} symbols): {parse:.3f} ms a chunk, "
        f"of which crc32_device(length=) {crc:.3f} ms")
    # the max-length window demod_at_fused reads for that parse: the dynamic
    # stream's buffer (max frame + a chunk of two shortest frames), starts
    # anywhere in the chunk's window [1, 1 + chunk)
    del tone, best, body
    buf_dyn = torch.randn(b_s, _buffer_len(cfg, chunk, PAYLOAD), generator=gen, device=DEV).to(torch.bfloat16)
    st_dyn = torch.randint(1, 1 + chunk, (b_s,), generator=gen, device=DEV)
    log_demod_time("dynamic parse window", cfg, buf_dyn, st_dyn, n_sym_max)
    return results


def generic_frame_config() -> ModemConfig:
    """sps 80 with 16 tones, 4 bits a symbol: a geometry of decide_frame_tm
    off the tensor-core walk (no preset has one; the custom configs of
    tests/test_torch_kernels_cuda.py)."""
    return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=600, num_tones=16, base_freq_hz=300.0)


def custom_tones_config() -> ModemConfig:
    """sps 96 with 32 tones: a geometry of decide_tones_tm off its
    tensor-core walk (no preset has one), two passes of the generic
    body's 16 tones."""
    return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=500, num_tones=32, base_freq_hz=250.0)


def noisy_data_sections(cfg, gen, dtype) -> torch.Tensor:
    """Time-major data sections [symbols x sps, COMPARE_B] of ``dtype``: 256
    frames of PAYLOAD random bytes at noise 0.3, past their preambles."""
    pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    w = transmit(cfg, pay, device=DEV)
    data = (w + 0.3 * torch.randn(w.shape, generator=gen, device=DEV)).T[cfg.preamble_samples :]
    return data.contiguous().to(dtype)


def compare_walk_tones(label: str, cfg, x: torch.Tensor, any_route: bool = False) -> float:
    """decide_tones_tm on its tensor-core walk (route "mma" for bfloat16
    rows, "split" for float32), or (``any_route``) on frame_tm_any.cu's
    ("tm_any", "tm_any_split"), against the plain energies of the same
    symbols: float32 as compare_split_decisions holds it; bfloat16 (bf16
    products exact, float32 sums in another order) with the tones equal
    but where the plain version's two largest energies lie within RTOL
    (ANY_RTOL on frame_tm_any) of the largest (their count printed), best
    and total within that of the symbol's largest energy. Returns the max
    absolute error."""
    f32 = x.dtype == torch.float32
    route = ("tm_any_split" if f32 else "tm_any") if any_route else ("split" if f32 else "mma")
    rtol = ANY_RTOL if any_route else RTOL
    if kernels._tm_operands("decide_tones_tm", cfg, x.dtype, DEV)[1] != route:
        raise AssertionError(f"{label}: decide_tones_tm does not take the {route} route")
    got = [v.T for v in kernels.decide_tones_tm(cfg, x)]
    want = tm_energies(cfg, x, 0, x.shape[0] // cfg.samples_per_symbol, x.dtype)
    if x.dtype == torch.float32:
        return compare_split_decisions(label, got, want)
    tone, best, total = got
    scale = want.amax(-1)
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= rtol * top2[..., 0]
    tone_bad = int(((tone != want.argmax(-1).int()) & ~near).sum())
    d_best, d_total = (best - scale).abs(), (total - want.sum(-1)).abs()
    best_bad, total_bad = int((d_best > rtol * scale).sum()), int((d_total > rtol * scale).sum())
    worst = max(float(d_best.max()), float(d_total.max()))
    log(f"  {label}: best/total max abs {worst:.3e}, beyond {rtol:g} of the symbol's largest: best {best_bad}, "
        f"total {total_bad}; near-ties {int(near.sum())} of {near.numel()}; tones differing off a near-tie "
        f"{tone_bad}")
    if tone_bad or best_bad or total_bad:
        raise AssertionError(f"{label}: decide_tones_tm's {route} route is beyond its tolerance")
    return worst


def phase_kernels_generic(gen) -> dict:
    """Phase 2 for the time-major pair off decide_frame_tm's walk.
    1. decide_tones_tm at both presets on decide_frame_tm.cu's tensor-core
       walk (kernels._filterbank_tensor_core_geometry: mfsk8-audible, sps
       48, 8 tones; mfsk32-dense, sps 80, 32 tones as 8 n-tiles with the
       basis in shared memory), bfloat16 (aligned-audible's) and float32
       (aligned-dense-f32's) data each: on the data sections of 256 noisy
       frames held with compare_walk_tones, then tiled to B = 16,384, held
       again and timed with the plain version against the bound (bytes, or
       the products at the bf16 peak): decide_tones_tm's "presets".
    2. csrc/frame_tm_any.cu, the runtime-geometry walk of every custom
       geometry: phase_kernels_tm_any."""
    reps = ALIGNED_B // COMPARE_B
    presets = {}
    for model in (AUDIBLE_MODEL, DENSE_MODEL):
        cfg = get_model(model).config
        sps, m = cfg.samples_per_symbol, cfg.num_tones
        for dtype in (torch.bfloat16, torch.float32):
            data = noisy_data_sections(cfg, gen, dtype)
            n_sym = data.shape[0] // sps
            label = f"decide_tones_tm walk ({model}, {str(dtype).removeprefix('torch.')}"
            err = compare_walk_tones(f"{label}, B {COMPARE_B})", cfg, data)
            full = data.repeat(1, reps)
            del data
            err = max(err, compare_walk_tones(f"{label}, B {ALIGNED_B})", cfg, full))
            torch.cuda.empty_cache()
            products = F32_SPLIT_PRODUCTS if dtype == torch.float32 else 1
            r = {"max_abs_err": err, "ms": time_ms(lambda: kernels.decide_tones_tm(cfg, full)),
                 "plain_ms": time_ms(lambda: kernels.decide_tones_tm_ref(cfg, full)), "library_ms": None}
            r["bound_ms"], r["bound_by"] = bound_ms(ALIGNED_B * n_sym * (sps * full.element_size() + 12),
                                                    products * n_sym * 2 * sps * 2 * m * ALIGNED_B)
            log(f"  {label}, B {ALIGNED_B}, {n_sym} symbols of {sps}, {m} tones): kernel {r['ms']:.3f} ms, "
                f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
            presets[f"{model} {str(dtype).removeprefix('torch.')}"] = r
            del full
            torch.cuda.empty_cache()
    results = {"decide_tones_tm presets": presets}
    results.update(phase_kernels_tm_any(gen))
    return results


def check_frame_any(label: str, cfg, x_tm: torch.Tensor, pre: int) -> float:
    """decide_frame_tm on frame_tm_any.cu (its route asserted) against its
    plain version: bf16 and int8 frames with check_frame (words and CRC
    counts bit-equal, the quality sums within ANY_RTOL of themselves, no
    absolute slack), float32 frames with check_frame_split."""
    route = "tm_any_split" if x_tm.dtype == torch.float32 else "tm_any"
    if kernels._tm_operands("decide_frame_tm", cfg, x_tm.dtype, DEV)[1] != route:
        raise AssertionError(f"{label}: decide_frame_tm does not take the {route} route")
    if x_tm.dtype == torch.float32:
        return check_frame_split(label, cfg, x_tm, pre)
    return check_frame(label, cfg, x_tm, pre, rtol=ANY_RTOL, atol=0.0)


def sps1920_config() -> ModemConfig:
    """25 baud at 48 kHz, 16 tones: 1,920 samples a symbol (120 k-steps)."""
    return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=25, num_tones=16, base_freq_hz=1000.0)


def tones64_config() -> ModemConfig:
    """sps 128 with 64 tones: past every compile-time walk's 32 tones, two
    groups of frame_tm_any.cu."""
    return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=375, num_tones=64, base_freq_hz=187.5)


# frame_tm_any.cu's held and timed shapes in phase 2: (label, config, wrapper,
# dtypes, B): aligned-custom's (sps 40, 16 tones, decide_frame_tm), the CUDA-core
# body's old ones (sps 96 with 32 tones and sps 40 with 8, decide_tones_tm; the
# frame epilogue at sps 80), sps 1,920 and 64 tones; payload 256's data symbols
TM_ANY_SHAPES = (
    ("sps40-m16", lambda: CUSTOM_STREAM_CONFIG, "decide_frame_tm", (torch.bfloat16, torch.int8, torch.float32),
     ALIGNED_B),
    ("sps96-m32", custom_tones_config, "decide_tones_tm", (torch.bfloat16, torch.float32), ALIGNED_B),
    ("sps40-m8", lambda: custom_filterbank_config(), "decide_tones_tm", (torch.bfloat16, torch.float32), ALIGNED_B),
    ("sps80-m16", generic_frame_config, "decide_frame_tm", (torch.bfloat16, torch.int8, torch.float32), ALIGNED_B),
    ("sps1920-m16", sps1920_config, "decide_frame_tm", (torch.bfloat16, torch.int8, torch.float32), 256),
    ("sps128-m64", tones64_config, "decide_tones_tm", (torch.bfloat16, torch.float32), 4096),
)


def phase_kernels_tm_any(gen) -> dict:
    """Phase 2 for csrc/frame_tm_any.cu, the time-major pair at every
    custom geometry off decide_frame_tm.cu's walk (TM_ANY_SHAPES): on the
    frames (decide_frame_tm, from the preamble's end) or data sections
    (decide_tones_tm) of COMPARE_B noisy frames, held against the plain
    version (check_frame_any; compare_walk_tones on the "tm_any" routes),
    then tiled to the shape's B, held again and timed with the plain
    version against the bound (bytes: the samples read once, the outputs
    written once; or the products at the peak of the samples' type). The
    kernels line's frame_tm_any row: aligned-custom's shape in bfloat16,
    float32 under "f32", every shape under "shapes"."""
    out, shapes = {}, {}
    for label, make, wrapper, dtypes, batch in TM_ANY_SHAPES:
        cfg = make()
        sps, m, pre = cfg.samples_per_symbol, cfg.num_tones, cfg.preamble_samples
        n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
        pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
        w = transmit(cfg, pay, device=DEV)
        w = w + 0.3 * torch.randn(w.shape, generator=gen, device=DEV)
        reps = batch // COMPARE_B
        for dtype in dtypes:
            name = f"{label} {wrapper} {str(dtype).removeprefix('torch.')}"
            if wrapper == "decide_frame_tm":
                x = quantize_x127(w) if dtype == torch.int8 else w.T.contiguous().to(dtype)
                err = check_frame_any(f"{TM_ANY_ROW} {name}, B {COMPARE_B}", cfg, x, pre)
                full = x.repeat(1, reps)
                del x
                err = max(err, check_frame_any(f"{TM_ANY_ROW} {name}, B {batch}", cfg, full, pre))
                call = lambda f: f(cfg, full, PAYLOAD, preamble_offset=pre)  # noqa: E731
                n_tiles = -(-n_sym // kernels.TM_SYMBOL_TILE)
                n_bytes = batch * (n_sym * sps * full.element_size() + 4 * (n_tiles + 64 + 8))
            else:
                x = w.T[pre:].contiguous().to(dtype)
                err = compare_walk_tones(f"{TM_ANY_ROW} {name}, B {COMPARE_B}", cfg, x, any_route=True)
                full = x.repeat(1, reps)
                del x
                err = max(err, compare_walk_tones(f"{TM_ANY_ROW} {name}, B {batch}", cfg, full, any_route=True))
                call = lambda f: f(cfg, full)  # noqa: E731
                n_bytes = batch * n_sym * (sps * full.element_size() + 12)
            torch.cuda.empty_cache()
            products = F32_SPLIT_PRODUCTS if dtype == torch.float32 else 1
            peak = INT8_OPS_S if dtype == torch.int8 else BF16_FLOPS_S
            r = {"max_abs_err": err, "ms": time_ms(lambda: call(getattr(kernels, wrapper))),
                 "plain_ms": time_ms(lambda: call(getattr(kernels, f"{wrapper}_ref"))), "library_ms": None,
                 "B": batch, "symbols": n_sym}
            r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, products * n_sym * 2 * sps * 2 * m * batch, peak)
            log(f"  {TM_ANY_ROW} {name}, B {batch}, {n_sym} symbols of {sps}, {m} tones: kernel {r['ms']:.3f} ms, "
                f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
            shapes[name] = r
            del full
            torch.cuda.empty_cache()
        del w
    main = shapes["sps40-m16 decide_frame_tm bfloat16"]
    out[TM_ANY_ROW] = {**main, "shapes": shapes}
    out[f"{TM_ANY_ROW}:f32"] = shapes["sps40-m16 decide_frame_tm float32"]
    return out


def custom_filterbank_config() -> ModemConfig:
    """sps 40 with 8 tones: a geometry off every compile-time walk (no
    preset has one), where the batch-major filterbank takes
    filterbank_any.cu and decide_tones_tm frame_tm_generic.cu."""
    return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=1200, num_tones=8, base_freq_hz=600.0)


# stream-custom-f32's and aligned-custom's config: 48 kHz, 1,200 baud (sps 40),
# 16 tones from 600 Hz (the top tone 18.6 kHz), a modem no preset has
CUSTOM_STREAM_CONFIG = ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=1200, num_tones=16, base_freq_hz=600.0)
# stream-slow-f32's config: 48 kHz, 100 baud (sps 480), 16 tones from 600 Hz
# (600-2,100 Hz, voice band): a 32-symbol preamble of 15,360 samples
SLOW_STREAM_CONFIG = ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=100, num_tones=16, base_freq_hz=600.0)
SLOW_STREAM_B = 1024  # its batch: 6 frames of 272,640 float32 samples a stream, 7.1 GB of capture
# filterbank_any.cu's held and timed geometries in phase 2: (label, config, B);
# sps 40 with 16 tones at B = 8,192 is stream-custom-f32's own shape, sps 480
# with 16 tones at B = 1,024 stream-slow-f32's (30 k-steps a symbol)
ANY_GEOMETRIES = (
    ("sps 40, 8 tones", custom_filterbank_config(), 4096),
    ("sps 40, 16 tones", CUSTOM_STREAM_CONFIG, STREAM_B),
    ("sps 480, 16 tones", SLOW_STREAM_CONFIG, SLOW_STREAM_B),
    ("sps 1920, 16 tones", ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=25, num_tones=16,
                                       base_freq_hz=1000.0), 256),
    ("sps 160, 64 tones", ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=300, num_tones=64,
                                      base_freq_hz=150.0), 2048),
)


def compare_mma_tones(label: str, cfg, x: torch.Tensor, route: str = "mma", rtol: float = RTOL) -> float:
    """tone_energies_fused and decide_tones_fused with bfloat16 compute
    (``route`` "mma", the compile-time walk, held to RTOL; or "any",
    filterbank_any.cu's, held to ANY_RTOL) on rows ``x`` against their plain
    versions: every energy, best and total within ``rtol`` of its symbol's
    largest plain energy (bf16 products exact, float32 sums in another
    order), the tones (decided, and the energies' argmax) equal but where
    the plain version's two largest energies lie that close (near-ties,
    their count printed). Returns the max absolute error."""
    if kernels._filterbank_operands("tone_energies", cfg, torch.bfloat16, DEV)[1] != route:
        raise AssertionError(f"{label}: bfloat16 compute does not take the {route} route")
    want = kernels.tone_energies_fused_ref(cfg, x, compute_dtype=torch.bfloat16)
    got = kernels.tone_energies_fused(cfg, x, compute_dtype=torch.bfloat16)
    scale = want.amax(-1)
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= rtol * top2[..., 0]
    del top2
    diff = (got - want).abs()
    worst = float(diff.max())
    share = float((diff / scale[..., None].clamp_min(1e-30)).max())
    bad = int((diff > rtol * scale[..., None]).sum())
    argmax_bad = int(((got.argmax(-1) != want.argmax(-1)) & ~near).sum())
    del got, diff
    tone, best, total = kernels.decide_tones_fused(cfg, x, compute_dtype=torch.bfloat16)
    tone_bad = int(((tone != want.argmax(-1).int()) & ~near).sum())
    d_best, d_total = (best - scale).abs(), (total - want.sum(-1)).abs()
    best_bad = int((d_best > rtol * scale).sum())
    total_bad = int((d_total > rtol * scale).sum())
    worst = max(worst, float(d_best.max()), float(d_total.max()))
    share = max(share, float((torch.maximum(d_best, d_total) / scale.clamp_min(1e-30)).max()))
    log(f"  {label}: max abs {worst:.3e}, max {share:.3e} of the symbol's largest; beyond rtol {rtol:g} of it: "
        f"energies {bad}, best {best_bad}, total {total_bad}; near-ties {int(near.sum())} of {near.numel()}; "
        f"energies' argmax differing off a near-tie {argmax_bad}, tones {tone_bad}")
    if bad or best_bad or total_bad or argmax_bad or tone_bad:
        raise AssertionError(f"{label}: the tensor-core filterbank is beyond its tolerance")
    return worst


def phase_kernels_filterbank_generic(gen) -> dict:
    """Phase 2 for the batch-major filterbank off the other walks' geometry.
    1. Its tensor-core routes at the two stream paths' shapes
       (kernels._filterbank_tensor_core_geometry): mfsk32-dense (sps 80, 32
       tones: 8 n-tiles, the basis in shared memory) under bfloat16 compute
       on bf16 rows (stream-dense's) and mfsk8-audible (sps 48, 8 tones)
       under float32 compute on float32 rows (stream-audible-f32's: the
       three-term split). tone_energies_fused and decide_tones_fused on the
       data sections of 256 noisy frames read in place past the preamble,
       against their plain versions with the walk's tolerances
       (compare_mma_tones; compare_split), then tiled to B = 16,384, held
       again and timed there against their bound (bytes, or the products
       at the bf16 peak): the two wrappers' "presets" results.
    2. filterbank_any.cu, the runtime-geometry walk of every custom
       geometry, at ANY_GEOMETRIES (sps 40 with 8 tones, B = 4,096; sps 40
       with 16, B = 8,192, stream-custom-f32's shape; sps 480 with 16, B =
       1,024, stream-slow-f32's; sps 1,920 with 16, B = 256; sps 160 with
       64, two groups, B = 2,048): bfloat16 compute on
       bf16 rows ("any", within ANY_RTOL) and float32 compute on float32
       rows ("any_split"), both wrappers on the data sections of 256 noisy
       frames and at B (compare_mma_tones; compare_split), then timed at B
       with the plain version against the bound (bytes, or the products at
       the bf16 peak: one, or the split's six): the FILTERBANK_ROW results
       (":f32" for float32 compute) at sps 40, decide_tones_fused's under
       "decide_tones", the other geometries under their labels. The
       parent's CUDA-core body has no place in this tree: its times come
       from ``python -m anet_torch.kernels.time_search --kernels
       filterbank_any`` on the parent's checkout."""
    results = {"tone_energies_fused": {}, "decide_tones_fused": {}}
    out_bytes = {"tone_energies_fused": None, "decide_tones_fused": 12}
    for model, cdt, n_products in ((DENSE_MODEL, torch.bfloat16, 1), (AUDIBLE_MODEL, torch.float32, 6)):
        cfg = get_model(model).config
        sps, m, pre = cfg.samples_per_symbol, cfg.num_tones, cfg.preamble_samples
        n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
        pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
        w = transmit(cfg, pay, device=DEV)
        x = (w + 0.3 * torch.randn(w.shape, generator=gen, device=DEV)).to(cdt)
        full = x.repeat(ALIGNED_B // COMPARE_B, 1)[:, pre:]
        del w
        compute = str(cdt).removeprefix("torch.")
        check = compare_mma_tones if cdt == torch.bfloat16 else compare_split
        err = max(check(f"tensor-core filterbank ({model}, {compute} compute, B {d.shape[0]})", cfg, d)
                  for d in (x[:, pre:], full))
        del x
        torch.cuda.empty_cache()
        for name, fn, ref in (("tone_energies_fused", kernels.tone_energies_fused, kernels.tone_energies_fused_ref),
                              ("decide_tones_fused", kernels.decide_tones_fused, kernels.decide_tones_fused_ref)):
            r = {"max_abs_err": err, "ms": time_ms(lambda: fn(cfg, full, compute_dtype=cdt)),
                 "plain_ms": time_ms(lambda: ref(cfg, full, compute_dtype=cdt)), "library_ms": None}
            o = out_bytes[name] or 4 * m
            r["bound_ms"], r["bound_by"] = bound_ms(ALIGNED_B * n_sym * (sps * full.element_size() + o),
                                                    n_products * n_sym * 2 * sps * 2 * m * ALIGNED_B)
            log(f"  {name} ({model}, {compute} compute, {compute} rows, B {ALIGNED_B}, {n_sym} symbols of {sps}, "
                f"{m} tones): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']})")
            results[name][f"{model} {compute} compute"] = r
            torch.cuda.empty_cache()
        del full
    # filterbank_any.cu at custom geometries
    for cdt, key, n_products in ((torch.bfloat16, FILTERBANK_ROW, 1), (torch.float32, f"{FILTERBANK_ROW}:f32", 6)):
        compute = str(cdt).removeprefix("torch.")
        if cdt == torch.bfloat16:
            route, check = "any", lambda *a: compare_mma_tones(*a, rtol=ANY_RTOL)
        else:
            route, check = "any_split", compare_split
        for label, cfg, b_full in ANY_GEOMETRIES:
            sps, m, pre = cfg.samples_per_symbol, cfg.num_tones, cfg.preamble_samples
            n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
            pay = torch.randint(0, 256, (COMPARE_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
            w = transmit(cfg, pay, device=DEV)
            x = (w + 0.3 * torch.randn(w.shape, generator=gen, device=DEV)).to(cdt)
            del w
            full = x.repeat(b_full // COMPARE_B, 1)[:, pre:]
            err = max(check(f"{FILTERBANK_ROW} ({label}, {compute} compute, B {d.shape[0]})", cfg, d, route)
                      for d in ((x[:, pre:], full) if b_full > COMPARE_B else (full,)))
            del x
            torch.cuda.empty_cache()
            timed = {}
            for name, fn, ref, o in (
                ("tone_energies_fused", kernels.tone_energies_fused, kernels.tone_energies_fused_ref, m * 4),
                ("decide_tones_fused", kernels.decide_tones_fused, kernels.decide_tones_fused_ref, 12),
            ):
                r = {"max_abs_err": err, "ms": time_ms(lambda: fn(cfg, full, compute_dtype=cdt)),
                     "plain_ms": time_ms(lambda: ref(cfg, full, compute_dtype=cdt)), "library_ms": None}
                r["bound_ms"], r["bound_by"] = bound_ms(b_full * n_sym * (sps * full.element_size() + o),
                                                        n_products * n_sym * 2 * sps * 2 * m * b_full)
                log(f"  {FILTERBANK_ROW} {name} ({label}, {compute} compute, {compute} rows, B {b_full}, "
                    f"{n_sym} symbols): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                    f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
                timed[name] = r
                torch.cuda.empty_cache()
            del full
            entry = {**timed["tone_energies_fused"], "decide_tones": timed["decide_tones_fused"]}
            if key not in results:  # the first geometry, sps 40: the row's own numbers
                results[key] = {**entry, "geometry": f"{label}, B {b_full}"}
            else:
                results[key][f"{label}, B {b_full}"] = entry
    return results


# stream-sps16-int8's modem: 48 kHz, 3,000 baud (sps 16), 4 tones from 3 kHz
SPS16_CONFIG = ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=3_000, num_tones=4)
# stream-resident-m32's: 48 kHz, 375 baud (sps 128), 32 tones from 3 kHz
M32_CONFIG = ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=375, num_tones=32)
# demod_at_any.cu (the align+demod kernels off demod_at.cu's walk): held
# and timed at the two new paths' modems at B = 8,192, held at the rest of
# the reference's gate (128 % sps == 0) at 256 streams: A rows of 4 and 2
# short symbols, one and two groups of 32 tones
AT_ANY_MAIN = (("sps 16, 4 tones", SPS16_CONFIG), ("sps 128, 32 tones", M32_CONFIG))
AT_ANY_SHAPES = (
    ("sps 4, 2 tones", ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=12_000, num_tones=2, base_freq_hz=3_000.0)),
    ("sps 8, 4 tones", ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=6_000, num_tones=4, base_freq_hz=3_000.0)),
    ("sps 64, 32 tones", ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=750, num_tones=32, base_freq_hz=375.0)),
    ("sps 128, 64 tones", ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=375, num_tones=64, base_freq_hz=187.5)),
)
AT_ANY_DTYPES = (("bf16", torch.bfloat16), ("int8", torch.int8), ("f32", torch.float32))


def compare_scaled(label: str, got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor, rtol: float) -> float:
    """``got`` within ``rtol`` of ``scale`` (the symbol's largest plain
    energy) of the plain ``want``. Returns the max absolute error."""
    diff = (got.double() - want.double()).abs()
    bad = int((diff > rtol * scale.double()).sum())
    worst = float(diff.max())
    log(f"  {label}: max abs {worst:.3e}, max {float((diff / scale.double().clamp_min(1e-30)).max()):.3e} of the "
        f"symbol's largest energy; beyond {rtol:g} of it {bad}")
    if bad:
        raise AssertionError(f"{label}: beyond {rtol:g} of the symbol's largest energy in {bad} places")
    return worst


def check_at_any(label: str, cfg, buf: torch.Tensor, starts: torch.Tensor, n_sym: int, tpl: torch.Tensor) -> float:
    """demod_at_fused, demod_at_energies_fused and demod_probe_fused (at
    starts - 2, n_lags 5) on demod_at_any.cu (the route asserted: one launch
    each under its key for the buffer's dtype, none elsewhere) against their
    plain versions. int8 (exact int32 I/Q): tones and best bit-equal,
    energies bit-equal, total within rtol 1e-5; bfloat16: tones bit-equal,
    best, total and energies within ANY_RTOL of the symbol's largest energy;
    float32: the three-term split's tolerance and near-tie rule
    (compare_split_decisions, compare_split_energies); the probe's offsets
    all 2, the planted lag. Returns the max absolute error."""
    if kernels._demod_at_operands(label, "demod_at", cfg, buf.dtype, DEV)[1] != "at_any":
        raise AssertionError(f"{label}: the align+demod kernels do not take demod_at_any.cu")
    before = dict(kernels.launch_counts)
    got = kernels.demod_at_fused(cfg, buf, starts, n_sym)
    energies = kernels.demod_at_energies_fused(cfg, buf, starts, n_sym)
    probe = kernels.demod_probe_fused(cfg, buf, starts - 2, n_sym, tpl, n_lags=N_LAGS)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in kernels.launch_counts.items() if v != before[k]}
    key = AT_ANY_ROW + {torch.int8: ":int8", torch.float32: ":f32"}.get(buf.dtype, "")
    if delta != {key: 3}:
        raise AssertionError(f"{label}: launches {delta}, not three under {key}")
    want_e = kernels.demod_at_energies_fused_ref(cfg, buf, starts, n_sym)
    want_p = kernels.demod_probe_fused_ref(cfg, buf, starts - 2, n_sym, tpl, n_lags=N_LAGS)
    if not (torch.equal(probe[1], want_p[1]) and bool((probe[1] == 2).all())):
        raise AssertionError(f"{label}: demod_probe_fused's servo missed the planted starts")
    err = compare(f"{label} demod_probe_fused probe", probe[:3], want_p[:3], (1,), (0, 2))
    if buf.dtype == torch.float32:
        err = max(err, compare_split_decisions(f"{label} demod_at_fused", got, want_e),
                  compare_split_energies(f"{label} demod_at_energies_fused", energies, want_e),
                  compare_split_decisions(f"{label} demod_probe_fused demod", probe[3:], want_e))
        return err
    want = kernels.demod_at_fused_ref(cfg, buf, starts, n_sym)
    if buf.dtype == torch.int8:
        err = max(err, compare(f"{label} demod_at_fused", got, want, (0, 1), (2,), rtol=1e-5, atol=0),
                  compare(f"{label} demod_probe_fused demod", probe[3:], want, (0, 1), (2,), rtol=1e-5, atol=0),
                  compare(f"{label} demod_at_energies_fused", (energies,), (want_e,), (0,), ()))
        return err
    scale = want_e.amax(-1)
    for name, (tone, best, total) in (("demod_at_fused", got), ("demod_probe_fused demod", probe[3:])):
        if not torch.equal(tone, want[0]):
            raise AssertionError(f"{label} {name}: tones differ in {int((tone != want[0]).sum())} places")
        err = max(err, compare_scaled(f"{label} {name} best", best, want[1], scale, ANY_RTOL),
                  compare_scaled(f"{label} {name} total", total, want[2], scale, ANY_RTOL))
    if not torch.equal(energies.argmax(-1).int(), want[0]):
        raise AssertionError(f"{label} demod_at_energies_fused: the energies' argmax differs from the tones")
    return max(err, compare_scaled(f"{label} demod_at_energies_fused", energies, want_e, scale[..., None], ANY_RTOL))


def at_any_buffers(cfg, gen, b: int):
    """(bf16, int8 and float32 stream buffers [b, L] as the carries hold
    them, starts): noise 0.05 and a frame at each start, the data sections
    of the first 16 at every byte residue mod 16 (rows of whole 16 bytes),
    the rest at random starts below 1,000."""
    pay = torch.randint(0, 256, (b, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    waves = transmit(cfg, pay, device=DEV)
    length = -(-(waves.shape[1] + 1300) // 64) * 64
    starts = torch.randint(3, 1000, (b,), generator=gen, device=DEV)
    starts[:16] = 1000 + torch.arange(16, device=DEV)
    bf16, i8, f32 = plant_frames(waves, starts, length, 0.05, gen)
    return {"bf16": bf16, "int8": i8, "f32": f32}, starts.int()


def at_any_occupancy(o: dict) -> str:
    """demod_at_any.cu's instantiation at a launch's geometry (from
    kernels.demod_at_any_occupancy), for the log."""
    return (f"{o['blocks_per_sm']} blocks an SM of {o['threads']} threads, {o['smem_bytes']} B shared, "
            f"KS {o['ks']}, NT {o['nt']}, {o['mt']} m16 tiles an item, {o['registers']} registers, "
            f"{o['local_bytes']} B local")


def phase_kernels_demod_at_any(gen) -> dict:
    """Phase 2 for demod_at_any.cu, the align+demod kernels at the
    reference's geometries off demod_at.cu's walk. At AT_ANY_MAIN
    (stream-sps16-int8's modem, sps 16 with 4 tones, 1,072 symbols; and
    stream-resident-m32's, sps 128 with 32 tones, 429 symbols) on bf16,
    int8 and float32 buffers of 256 streams, then of B = 8,192: the three
    wrappers held against their plain versions (check_at_any), then timed
    with them against the bound (each stream's data span read once, the
    outputs written once; the products at the peak of their type: int8's,
    or bf16's for one product and the split's six; the probe's span and
    correlations besides). At AT_ANY_SHAPES (sps 4 with 2 tones, sps 8 with
    4, sps 64 with 32, sps 128 with 64) held at 256 streams. Each main
    geometry's two instantiations (decisions, energies) log their
    occupancy (blocks an SM, registers, spills). The results:
    AT_ANY_ROW's, ":int8" and ":f32" by dtype, demod_at_fused at sps 16
    the row's own numbers, the other wrappers and geometries under their
    labels."""
    results = {}
    for cfg_label, cfg in (*AT_ANY_MAIN, *AT_ANY_SHAPES):
        sps, m = cfg.samples_per_symbol, cfg.num_tones
        n_sym = tframe.data_symbols_for_payload(cfg, PAYLOAD)
        tpl = preamble_waveform(cfg, device=DEV).to(torch.bfloat16)
        k = tpl.shape[-1]
        small, starts = at_any_buffers(cfg, gen, COMPARE_B)
        main = (cfg_label, cfg) in AT_ANY_MAIN
        for dlabel, dt in AT_ANY_DTYPES:
            key = AT_ANY_ROW if dt == torch.bfloat16 else f"{AT_ANY_ROW}:{dlabel}"
            buf = small[dlabel]
            err = check_at_any(f"{AT_ANY_ROW} ({cfg_label}, {dlabel}, B {COMPARE_B})", cfg, buf, starts, n_sym, tpl)
            entry = {"max_abs_err": err}
            if main:
                reps = STREAM_B // COMPARE_B
                full, st_full = buf.repeat(reps, 1), starts.repeat(reps)
                err = max(err, check_at_any(f"{AT_ANY_ROW} ({cfg_label}, {dlabel}, B {STREAM_B})", cfg, full,
                                            st_full, n_sym, tpl))
                es, b = full.element_size(), STREAM_B
                peak = INT8_OPS_S if dt == torch.int8 else BF16_FLOPS_S
                n_products = F32_SPLIT_PRODUCTS if dt == torch.float32 else 1
                ops = n_products * n_sym * 2 * sps * 2 * m * b
                st0 = st_full - 2
                pw_e = -(-(k + N_LAGS - 1) // 128) + 1
                lo = torch.minimum(st0 // 128 * 128, st0)
                hi = torch.maximum(st0 // 128 * 128 + pw_e * 128, st0 + 2 + cfg.preamble_samples + n_sym * sps)
                probe_ops = b * (2 * N_LAGS * k + 2 * pw_e * 128)
                if dt == torch.float32:
                    probe_ops *= BF16_FLOPS_S / F32_FLOPS_S  # float32 multiply-adds on the CUDA cores
                timed = {}
                for name, call, n_bytes, n_ops in (
                    ("demod_at_fused", lambda f: f(cfg, full, st_full, n_sym),
                     b * (n_sym * (sps * es + 12) + 4), ops),
                    ("demod_at_energies_fused", lambda f: f(cfg, full, st_full, n_sym),
                     b * (n_sym * (sps * es + 4 * m) + 4), ops),
                    ("demod_probe_fused", lambda f: f(cfg, full, st0, n_sym, tpl, n_lags=N_LAGS),
                     float((hi - lo).sum()) * es + b * (16 + n_sym * 12), ops + probe_ops),
                ):
                    r = {"max_abs_err": err, "ms": time_ms(lambda: call(getattr(kernels, name))),
                         "plain_ms": time_ms(lambda: call(getattr(kernels, f"{name}_ref"))), "library_ms": None}
                    r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, n_ops, peak)
                    log(f"  {AT_ANY_ROW} {name} ({cfg_label}, {dlabel}, B {b}, {n_sym} symbols): kernel "
                        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                        f"({r['bound_by']})")
                    timed[name] = r
                    torch.cuda.empty_cache()
                del full
                for decide in (True, False):  # each instantiation's launch as the card gives it
                    log(f"  {AT_ANY_ROW} {'decisions' if decide else 'energies'} ({cfg_label}, {dlabel}): "
                        f"{at_any_occupancy(kernels.demod_at_any_occupancy(cfg, dt, n_sym, decide))}")
                entry = {**timed.pop("demod_at_fused"), **timed}
            if key not in results:  # sps 16, 4 tones: the row's own numbers
                results[key] = {**entry, "geometry": f"{cfg_label}, B {STREAM_B}, demod_at_fused"}
            else:
                results[key][cfg_label] = entry
        del small
        torch.cuda.empty_cache()
    return results


def phase_aligned(cfg, gen, label: str = "aligned", batch: int = ALIGNED_B, iters: int = 5,
                  dtype: torch.dtype = torch.bfloat16) -> None:
    """Phase 3: the aligned time-major receiver at the full batch, frames
    and compute in ``dtype``: bfloat16 (the default compute), float32, or
    int8, the quantized-ingest path (frames quantized x127 over the
    batch's maximum)."""
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    pay = torch.randint(0, 256, (batch, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    waves = transmit(cfg, pay, device=DEV)
    # one untimed ingest cast
    x_tm = quantize_x127(waves) if dtype == torch.int8 else waves.to(dtype).T.contiguous()
    del waves
    kw = {} if dtype == torch.bfloat16 else {"compute_dtype": dtype}
    res = tframe.demodulate_frame_tm(cfg, x_tm, PAYLOAD, device=DEV, **kw)
    ok_frac = float(res.ok.float().mean())
    if ok_frac != 1.0 or not torch.equal(res.payload, pay):
        raise AssertionError(f"{label}: frames_ok_fraction {ok_frac}, payloads equal "
                             f"{torch.equal(res.payload, pay)}")
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        n_ok = tframe.demodulate_frame_tm(cfg, x_tm, PAYLOAD, device=DEV, **kw).ok.sum()
    int(n_ok)
    dt = time.perf_counter() - t0
    log(f"{label}: B {batch}, frames_ok_fraction {ok_frac}, "
        f"{batch * t_frame * iters / dt / 1e6:.1f} Msamples/s ({dt / iters * 1e3:.2f} ms/batch)")


@contextlib.contextmanager
def uncounted():
    """Launches inside the block do not count toward the path's: a run that
    a path's result is compared with."""
    saved = dict(kernels.launch_counts)
    try:
        yield
    finally:
        kernels.launch_counts.update(saved)


@contextlib.contextmanager
def plain_filterbank():
    """Inside the block, uncounted, tone_energies_fused is its plain version
    (on the card): the route whose payloads and verdicts a float32-compute
    path must give."""
    saved = kernels.tone_energies_fused
    kernels.tone_energies_fused = kernels.tone_energies_fused_ref
    try:
        with uncounted():
            yield
    finally:
        kernels.tone_energies_fused = saved


VERDICTS = ("payload", "magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok")


def same_verdicts(a, b) -> bool:
    """Two FrameResults' payloads and verdicts are equal."""
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in VERDICTS)


def verdict_words(out: str) -> list[str]:
    """The verdicts a modem-rx output prints (offset, ok, len, magic, crc
    fields), without its measured numbers (quality, snr)."""
    return re.findall(r"\b(?:offset|ok|len|magic|crc)=\S+", out)


def locked_stream_capture(cfg, gen, label: str, dtype: torch.dtype = torch.bfloat16, batch: int = STREAM_B):
    """(capture [batch, total], payloads [frames, B, payload], chunk,
    total) of phase 4: a GAP0-sample gap, then N_FRAMES back-to-back frames,
    of ``dtype`` (bf16, float32, or int8 through quantize_int8); chunk =
    frame // 128 * 128."""
    t_frame = family.frame_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    total = -(-(GAP0 + N_FRAMES * t_frame) // chunk) * chunk
    ingest = quantize_int8 if dtype == torch.int8 else (lambda w: w.to(dtype))
    cap = torch.zeros(batch, total, dtype=dtype, device=DEV)
    tx = family.transmit_fn(cfg, DEV)
    sent = []
    for i in range(N_FRAMES):
        pay = torch.randint(0, 256, (batch, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
        pos = GAP0 + i * t_frame
        cap[:, pos : pos + t_frame] = ingest(tx(pay))
        sent.append(pay)
    sent = torch.stack(sent)  # [frames, B, payload]
    log(f"{label}: B {batch}, capture {total} samples {str(dtype).removeprefix('torch.')} "
        f"({cap.numel() * cap.element_size() / 1e9:.2f} GB), chunk {chunk}")
    return cap, sent, chunk, total


def stream_frames_right(steps, sent: torch.Tensor) -> bool:
    """Every stream detected N_FRAMES frames and their payloads, in time
    order, are ``sent`` [frames, B, payload]."""
    det = steps.detected  # [chunks, B]
    if not bool((det.sum(0) == N_FRAMES).all()):
        return False
    got = steps.frame.payload.transpose(0, 1)[det.T]  # stream by stream, chunks in order
    return torch.equal(got.reshape(STREAM_B, N_FRAMES, -1), sent.transpose(0, 1))


def phase_stream(cfg, gen, label: str = "stream", dtype: torch.dtype = torch.bfloat16,
                 runs: tuple[str, ...] = ("cold", "warm-lock"), batch: int = STREAM_B) -> None:
    """Phase 4: the locked streaming receiver at B = 8,192 (or ``batch``),
    cold and warm (either family), through the carry path (resident=False),
    on a carry of ``dtype``: bf16 with bf16 compute; int8 with bf16
    compute, the capture quantized once at the ingest edge
    (quantize_int8); float32 with float32 compute, receive_stream's
    defaults."""
    cap, sent, chunk, total = locked_stream_capture(cfg, gen, label, dtype, batch)
    compute = torch.float32 if dtype == torch.float32 else torch.bfloat16
    fresh = {  # a cold carry of None is receive_stream's own: a buffer of the compute dtype
        "cold": lambda: init_carry(cfg, chunk, PAYLOAD, (batch,), dtype=dtype, device=DEV)
        if dtype == torch.int8 else None,
        "warm-lock": lambda: warm_lock_carry(cfg, chunk, PAYLOAD, batch, DEV, dtype),
    }
    for run in runs:
        carry = fresh[run]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = receive_stream(cfg, cap, chunk, PAYLOAD, carry=carry, compute_dtype=compute, lock=True,
                             resident=False, device=DEV)
        frames_ok = int(res.carry.frames_ok.sum())
        dt = time.perf_counter() - t0
        det = res.steps.detected
        got = res.steps.frame.payload[det.any(1)]  # [frames, B, payload]
        right = bool(det.sum(0).eq(N_FRAMES).all()) and got.shape == sent.shape and torch.equal(got, sent)
        log(f"{label} {run}: frames_ok {frames_ok} of {batch * N_FRAMES}, payloads right {right}, "
            f"{batch * total / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")
        if frames_ok != batch * N_FRAMES or not right:
            raise AssertionError(f"{label} {run}: frames_ok {frames_ok}, payloads right {right}")
        if run == "cold" and launched(kernels.launch_counts, "sync_search_fused") == 0:
            raise AssertionError(f"{label} cold: the search kernel never launched")
        del res, carry


def phase_oneshot_tracked(cfg, gen) -> None:
    """"oneshot-tracked": receive_frame_tracked on 2,048 float32 captures of
    38,400 samples, each frame at a random start below 1,500, drifted on the
    card by 700-1,000 ppm either way (drift_rows, linear interpolation) with
    white noise at 14 dB. Every frame ok with its payload, every drift
    estimate of the offset's opposite sign and within 15% + 30 ppm of it;
    the block receiver (receive_frame, whose launches do not count) decodes
    fewer frames of the same batch. Two calls, each timed."""
    b, n = ONESHOT_B, 38400
    pay, cap, ppm = drifted_oneshot_captures(cfg, b, n, gen, DEV)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = receive_frame_tracked(cfg, cap, PAYLOAD, device=DEV)
        n_ok = int(res.frame.ok.sum())
        times.append(time.perf_counter() - t0)
    right = torch.equal(res.frame.payload, pay)
    est = res.drift_ppm
    sign = bool((est * ppm < 0).all())
    miss = (est.abs() - ppm.abs()).abs() / ppm.abs()
    within = bool(((est.abs() - ppm.abs()).abs() < 0.15 * ppm.abs() + 30).all())
    with uncounted():
        block_ok = int(receive_frame(cfg, cap, PAYLOAD, device=DEV).frame.ok.sum())
    log(f"oneshot-tracked: B {b}, capture {n}, |ppm| {float(ppm.abs().min()):.1f}-{float(ppm.abs().max()):.1f}, "
        f"ok {n_ok}, payloads right {right}, drift sign right {sign}, within 15% + 30 ppm {within} "
        f"(worst {float(miss.max()):.4f} of |ppm|, mean {float(miss.mean()):.4f}), timing error rms mean "
        f"{float(res.timing_error_rms.mean()):.4f}; block receiver ok {block_ok}; "
        f"{b * n / times[1] / 1e6:.1f} Msamples/s ({times[0] * 1e3:.1f} ms first call, "
        f"{times[1] * 1e3:.1f} ms second)")
    if n_ok != b or not (right and sign and within) or block_ok >= b:
        raise AssertionError(f"oneshot-tracked: ok {n_ok}, payloads {right}, sign {sign}, within {within}, "
                             f"block ok {block_ok}")


def phase_stream_tracked(cfg, gen) -> None:
    """"stream-tracked": receive_stream(track=True) at B = 8,192 on phase 4's
    layout (GAP0 zeros, then 6 frames), each row drifted on the card by
    700-1,000 ppm either way with white noise at 14 dB (bf16): every frame
    ok with its payload. The search kernel finds each candidate; the
    tracker (plain PyTorch) demodulates it."""
    cap, sent, ppm, chunk = drifted_stream_capture(cfg, STREAM_B, gen, DEV)
    total = cap.shape[1]
    log(f"stream-tracked: B {STREAM_B}, capture {total} samples bf16 ({cap.numel() * 2 / 1e9:.2f} GB), "
        f"chunk {chunk}, |ppm| {float(ppm.abs().min()):.1f}-{float(ppm.abs().max()):.1f}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = receive_stream(cfg, cap, chunk, PAYLOAD, compute_dtype=torch.bfloat16, track=True, device=DEV)
    frames_ok = int(res.carry.frames_ok.sum())
    dt = time.perf_counter() - t0
    right = stream_frames_right(res.steps, sent)
    log(f"stream-tracked: frames_ok {frames_ok} of {STREAM_B * N_FRAMES}, payloads right {right}, "
        f"{STREAM_B * total / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")
    if frames_ok != STREAM_B * N_FRAMES or not right:
        raise AssertionError(f"stream-tracked: frames_ok {frames_ok}, payloads right {right}")


def phase_stream_resident(cfg, gen, label: str = "stream-resident") -> None:
    """"stream-resident" (or ``label``): receive_stream(lock=True,
    resident=True) on phase 4's bf16 capture at B = 8,192, cold and warm,
    each after the carry path (resident=False, its launches uncounted) on
    the same capture: every frame ok with its payload, and the detections,
    frames_ok and the final carry (buffer and counters) equal to the carry
    path's. Both throughputs logged."""
    cap, sent, chunk, total = locked_stream_capture(cfg, gen, label)
    fresh = {
        "cold": lambda: None,
        "warm-lock": lambda: warm_lock_carry(cfg, chunk, PAYLOAD, STREAM_B, DEV),
    }
    for run, carry in fresh.items():
        rates = {}
        for resident in (False, True):
            c = carry()
            with contextlib.nullcontext() if resident else uncounted():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = receive_stream(cfg, cap, chunk, PAYLOAD, carry=c, compute_dtype=torch.bfloat16, lock=True,
                                     resident=resident, device=DEV)
                frames_ok = int(res.carry.frames_ok.sum())
                dt = time.perf_counter() - t0
            rates[resident] = (STREAM_B * total / dt / 1e6, dt)
            if not resident:
                ref = res
            del c
        right = stream_frames_right(res.steps, sent)
        same = torch.equal(res.steps.detected, ref.steps.detected) and all(
            torch.equal(getattr(res.carry, f), getattr(ref.carry, f)) for f in res.carry._fields
        )
        log(f"{label} {run}: frames_ok {frames_ok} of {STREAM_B * N_FRAMES}, payloads right {right}, "
            f"frames and final carry equal to the carry path's {same}; resident "
            f"{rates[True][0]:.1f} Msamples/s ({rates[True][1]:.3f} s), carry path {rates[False][0]:.1f} "
            f"Msamples/s ({rates[False][1]:.3f} s)")
        if frames_ok != STREAM_B * N_FRAMES or not right or not same:
            raise AssertionError(f"{label} {run}: frames_ok {frames_ok}, payloads right {right}, "
                                 f"equal to the carry path {same}")
        if run == "cold" and kernels.launch_counts["sync_search_fused"] == 0:
            raise AssertionError(f"{label} cold: the search kernel never launched")
        del res, ref
        torch.cuda.empty_cache()


def frames_in_time_order(steps, n_frames: int):
    """(starts [n, B], declared lengths [n, B], payloads [n, B, max]) of each
    stream's first ``n_frames`` detections in time order; the steps may
    carry a per-chunk candidate axis ([chunks, K, B]) or not ([chunks, B])."""
    b = steps.detected.shape[-1]
    det = steps.detected.reshape(-1, b)
    start = steps.frame_start.reshape(-1, b)
    key = torch.where(det, start, torch.full_like(start, 2**31 - 1))
    order = key.argsort(0)[:n_frames]  # [n, B]
    plen = steps.frame.payload_len.reshape(-1, b).gather(0, order)
    payload = steps.frame.payload.reshape(-1, b, steps.frame.payload.shape[-1])
    payload = payload.gather(0, order[..., None].expand(-1, -1, payload.shape[-1]))
    return key.gather(0, order), plen, payload


def phase_stream_dynamic(cfg, gen, label: str, lens, lock: bool, batch: int = STREAM_B,
                         int8: bool = False) -> None:
    """Phase 5: a variable-length stream at B = 8,192 (or ``batch``):
    always-search with two candidates a chunk (chunk = two shortest frames),
    or frame lock cold and warm (chunk = one shortest frame, rounded down to
    128). With ``int8`` the bf16 capture enters int8 carries (init_carry),
    so receive_stream_dynamic quantizes it at ingest."""
    t_short = int(tframe.dynamic_frame_samples(cfg, min(lens)))
    chunk = (t_short if lock else 2 * t_short) // 128 * 128
    cap, sent = back_to_back_capture(cfg, lens, PAYLOAD, chunk, batch, gen, DEV)
    total = cap.shape[1]
    frame_len = [int(tframe.dynamic_frame_samples(cfg, n)) for n in lens]
    starts = GAP0 + np.concatenate([[0], np.cumsum(frame_len[:-1])])
    log(f"{label}: B {batch}, capture {total} samples bf16 ({cap.numel() * 2 / 1e9:.2f} GB), "
        f"{total // chunk} chunks of {chunk}, payloads {tuple(lens)}"
        f"{', int8 carries' if int8 else ''}")
    dtype = torch.int8 if int8 else torch.bfloat16
    cold = init_carry(cfg, chunk, PAYLOAD, (batch,), dtype=dtype, device=DEV) if int8 else None
    runs = (("cold", cold), ("warm-lock", warm_lock_carry(cfg, chunk, PAYLOAD, batch, DEV, dtype))) if lock \
        else (("search", None),)
    for run, carry in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = receive_stream_dynamic(
            cfg, cap, chunk, PAYLOAD, carry=carry, compute_dtype=torch.bfloat16,
            max_frames_per_chunk=1 if lock else 2, lock=lock, device=DEV,
        )
        frames_ok = int(res.carry.frames_ok.sum())
        dt = time.perf_counter() - t0
        det = res.steps.detected
        got_start, got_len, got_pay = frames_in_time_order(res.steps, len(lens))
        right = bool(det.reshape(-1, batch).sum(0).eq(len(lens)).all())
        for i, (n, pay) in enumerate(zip(lens, sent)):
            right = right and bool((got_len[i] == n).all()) and torch.equal(got_pay[i, :, :n], pay)
            right = right and not bool(got_pay[i, :, n:].any())
            # a locked start may sit up to 2 samples off (the drift servo)
            right = right and bool(((got_start[i] - int(starts[i])).abs() <= (2 if lock else 0)).all())
        log(f"{label} {run}: frames_ok {frames_ok} of {batch * len(lens)}, payloads and lengths right "
            f"{right}, {batch * total / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")
        if frames_ok != batch * len(lens) or not right:
            raise AssertionError(f"{label} {run}: frames_ok {frames_ok}, payloads and lengths right {right}")
        if not lock and not bool((det.sum(1) == 2).any()):
            raise AssertionError(f"{label}: no chunk completed two frames")
        if run == "cold" and kernels.launch_counts["sync_search_fused"] == 0:
            raise AssertionError(f"{label} cold: the search kernel never launched")
        del res, got_pay


def phase_aligned_window(cfg, gen, iters: int = 5, label: str = "aligned-window",
                         dtype: torch.dtype = torch.bfloat16) -> None:
    """Phase 6: the aligned receiver on an oversized window: 16,384
    time-major frames, each followed by 8 symbols of noise, rows and
    compute in ``dtype`` (bfloat16 or float32)."""
    sps = cfg.samples_per_symbol
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    pay = torch.randint(0, 256, (ALIGNED_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    x = torch.empty(ALIGNED_B, t_frame + 8 * sps, dtype=dtype, device=DEV)
    x[:, :t_frame] = transmit(cfg, pay, device=DEV).to(dtype)
    x[:, t_frame:] = torch.randn(ALIGNED_B, 8 * sps, generator=gen, device=DEV).to(dtype)
    x_tm = x.T.contiguous()
    del x
    kw = {"compute_dtype": dtype}
    res = tframe.demodulate_frame_tm(cfg, x_tm, PAYLOAD, device=DEV, **kw)
    ok_frac = float(res.ok.float().mean())
    if ok_frac != 1.0 or not torch.equal(res.payload, pay):
        raise AssertionError(f"{label}: frames_ok_fraction {ok_frac}, payloads equal "
                             f"{torch.equal(res.payload, pay)}")
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        n_ok = tframe.demodulate_frame_tm(cfg, x_tm, PAYLOAD, device=DEV, **kw).ok.sum()
    int(n_ok)
    dt = time.perf_counter() - t0
    log(f"{label}: B {ALIGNED_B}, window {x_tm.shape[0]} samples, frames_ok_fraction {ok_frac}, "
        f"{ALIGNED_B * x_tm.shape[0] * iters / dt / 1e6:.1f} Msamples/s ({dt / iters * 1e3:.2f} ms/batch)")


def phase_oneshot(cfg, gen) -> None:
    """Phase 6: the one-shot receivers on 2,048 captures whose frame starts
    at a per-stream random sample below 2,000: receive_frame (payload 256),
    receive_frame_dynamic (payload 100, declared in the header), then
    receive_frame's composition with aligned_gather(mode="roll")."""
    b, t_max, n = ONESHOT_B, tframe.frame_num_samples(cfg, PAYLOAD), 38400
    starts = torch.randint(0, 2000, (b,), generator=gen, device=DEV)

    def captures(payload_len):
        pay = torch.randint(0, 256, (b, payload_len), generator=gen, device=DEV, dtype=torch.uint8)
        waves = transmit(cfg, pay, device=DEV)
        cap = 0.05 * torch.randn(b, n, generator=gen, device=DEV)
        cap.scatter_add_(1, starts[:, None] + torch.arange(waves.shape[1], device=DEV), waves)
        return pay, cap.to(torch.bfloat16)

    pay, cap = captures(PAYLOAD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = receive_frame(cfg, cap, PAYLOAD, device=DEV)
    n_ok = int(res.frame.ok.sum())
    dt = time.perf_counter() - t0
    right = torch.equal(res.sync.offset, starts.int()) and torch.equal(res.frame.payload, pay)
    log(f"oneshot receive_frame: B {b}, capture {n}, ok {n_ok}, offsets and payloads right {right}, "
        f"{b * n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")
    if n_ok != b or not right:
        raise AssertionError(f"oneshot receive_frame: ok {n_ok} of {b}, offsets and payloads right {right}")
    with plain_filterbank():
        res_plain = receive_frame(cfg, cap, PAYLOAD, device=DEV)
    if not (same_verdicts(res.frame, res_plain.frame) and torch.equal(res.sync.offset, res_plain.sync.offset)):
        raise AssertionError("oneshot receive_frame: payloads or verdicts differ from the plain filterbank's")
    del res_plain
    # the same composition through the gather kernel
    start = res.sync.offset.clamp(0, n - t_max)
    plain = tsync.aligned_gather(cap, start, t_max)
    rolled = tsync.aligned_gather(cap, start, t_max, mode="roll")
    if not torch.equal(rolled.view(torch.int16), plain.view(torch.int16)):
        raise AssertionError("oneshot: aligned_gather(mode='roll') differs from the default gather")
    cap8 = quantize_int8(cap.float())  # the captures as an int8 carry holds them
    if not torch.equal(tsync.aligned_gather(cap8, start, t_max, mode="roll"), tsync.aligned_gather(cap8, start, t_max)):
        raise AssertionError("oneshot: aligned_gather(mode='roll') of int8 captures differs from the default gather")
    del cap8
    frame = tframe.demodulate_frame(cfg, rolled, PAYLOAD, device=DEV)
    if not bool(frame.ok.all()) or not torch.equal(frame.payload, pay):
        raise AssertionError("oneshot: frames gathered by the kernel do not decode")
    del res, plain, rolled, frame, cap

    short = 100
    pay, cap = captures(short)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dyn = receive_frame_dynamic(cfg, cap, PAYLOAD, device=DEV)
    n_ok = int(dyn.frame.ok.sum())
    dt = time.perf_counter() - t0
    right = (torch.equal(dyn.offset, starts.int()) and bool((dyn.frame.payload_len == short).all())
             and torch.equal(dyn.frame.payload[:, :short], pay) and not bool(dyn.frame.payload[:, short:].any()))
    log(f"oneshot receive_frame_dynamic: B {b}, ok {n_ok}, offsets, lengths and payloads right {right}, "
        f"{b * n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")
    if n_ok != b or not right:
        raise AssertionError(f"oneshot receive_frame_dynamic: ok {n_ok} of {b}, right {right}")


@functools.lru_cache(maxsize=1)
def batch_major_frames(cfg):
    """(payloads, bf16 frames [ALIGNED_B, T]) of the batch-major aligned
    paths, made once from their own seed so both paths get the same."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    pay = torch.randint(0, 256, (ALIGNED_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    return pay, transmit(cfg, pay, device=DEV).to(torch.bfloat16)  # one untimed ingest cast


BM_VERDICTS = {}  # the aligned-bm path's verdicts, which aligned-bm-decide must equal


def phase_aligned_bm(cfg, gen, decide: bool = False, iters: int = 5) -> None:
    """The batch-major aligned receiver on 16,384 bf16 mfsk16-fast frames:
    "aligned-bm", demodulate_frame (tone_energies_fused),
    or with ``decide`` "aligned-bm-decide", frame_result_from_tone_decisions
    of decide_tones_fused on the data sections read in place."""
    pay, x = batch_major_frames(cfg)
    pre = cfg.preamble_samples
    label = "aligned-bm-decide" if decide else "aligned-bm"

    def demod():
        if decide:
            tone, best, total = kernels.decide_tones_fused(cfg, x[:, pre:], compute_dtype=torch.bfloat16)
            return tframe.frame_result_from_tone_decisions(cfg, tone, best, total, PAYLOAD)
        return tframe.demodulate_frame(cfg, x, PAYLOAD, compute_dtype=torch.bfloat16, device=DEV)

    res = demod()
    ok_frac = float(res.ok.float().mean())
    verdicts = torch.stack([res.magic_ok, res.length_ok, res.header_crc_ok, res.payload_crc_ok, res.ok])
    if ok_frac != 1.0 or not torch.equal(res.payload, pay):
        raise AssertionError(f"{label}: frames_ok_fraction {ok_frac}, payloads equal {torch.equal(res.payload, pay)}")
    if decide and not torch.equal(verdicts, BM_VERDICTS.pop("aligned-bm")):
        raise AssertionError("aligned-bm-decide: verdicts differ from aligned-bm's")
    BM_VERDICTS.setdefault("aligned-bm", verdicts)
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        n_ok = demod().ok.sum()
    int(n_ok)
    dt = time.perf_counter() - t0
    t_frame = x.shape[1]
    log(f"{label}: B {ALIGNED_B}, frames_ok_fraction {ok_frac}, "
        f"{ALIGNED_B * t_frame * iters / dt / 1e6:.1f} Msamples/s ({dt / iters * 1e3:.2f} ms/batch)")
    if decide:
        batch_major_frames.cache_clear()


def occupancy(r: dict) -> str:
    """The slab kernel's launch as the card gives it (r["occupancy"], from
    kernels.search_slab_occupancy), for the log."""
    o = r["occupancy"]
    if o is None:
        return "the one-shot route"
    return (f"{o['blocks_per_sm']} blocks an SM of {o['threads']} threads, {o['rows']} rows, {o['smem_bytes']} B "
            f"shared, {o['slabs']} slabs of {o['ksl']} k-steps, {o['registers']} registers, {o['local_bytes']} B local")


LONG_TEMPLATES = (15_360, 61_440)  # sps 480's and sps 1,920's 32-symbol preambles
LONG_B, LONG_OUT_LEN = 64, 36_352  # phase 2's streams and lags at those templates
SEARCH_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                (torch.float32, torch.bfloat16), (torch.float32, torch.float32))


def phase_kernels_search_long(gen) -> dict:
    """Phase 2 for the search kernels past the one-shot stage
    (search_core.cuh's slab route): sync_search_fused, sync_search_blockmax
    and correlate_fused at templates of 15,360 and 61,440 samples, every
    (segment, template) dtype pair, LONG_B streams of noise with the
    template planted at a random lag, strided segments from sample 1: the
    search's lags equal to the plain version's and the planted ones, its
    qualities and the block maxima within RTOL, every lag of the
    correlation within RTOL of its scale; each timed with its plain
    version against its bound (the segment read once, the output written
    once, 2 k out_len B operations at the bf16 peak), correlate_fused also
    with its library call (float32 conv1d, TF32 off), each with the slab
    kernel's occupancy (blocks an SM, registers, spills; logged). Then
    sync_search_fused at stream-slow-f32's own shape (phase_search_slow).
    Returns {name: {"k <k> <seg>/<template>": numbers}}, the kernels line's
    "slab"."""
    out = {"sync_search_fused": {}, "sync_search_blockmax": {}, "correlate_fused": {}}
    b, n = LONG_B, LONG_OUT_LEN
    for k in LONG_TEMPLATES:
        t = torch.randn(k, generator=gen, device=DEV)
        lags = torch.randint(0, n, (b,), generator=gen, device=DEV)
        buf = torch.randn(b, n + k + 40, generator=gen, device=DEV)
        idx = 1 + lags[:, None] + torch.arange(k, device=DEV)
        buf.scatter_add_(1, idx, 0.5 * t.expand(b, k))
        for seg_dtype, tpl_dtype in SEARCH_PAIRS:
            seg = buf.to(seg_dtype)[:, 1 : n + k]
            tpl = t.to(tpl_dtype)
            te = float((tpl.float() ** 2).sum())
            label = f"k {k} {str(seg_dtype).removeprefix('torch.')}/{str(tpl_dtype).removeprefix('torch.')}"
            q, i = kernels.sync_search_fused(seg, tpl, n, te)
            rq, ri = kernels.sync_search_fused_ref(seg, tpl, n, te)
            if not (torch.equal(i, ri) and torch.equal(i, lags.int())):
                raise AssertionError(f"sync_search_fused ({label}): lags differ in {int((i != ri).sum())} streams")
            errs = {"sync_search_fused": compare(f"sync_search_fused slab ({label})", (q,), (rq,), (), (0,))}
            bm = kernels.sync_search_blockmax(seg, tpl, n, te)
            errs["sync_search_blockmax"] = compare(f"sync_search_blockmax slab ({label})", (bm,),
                                                   (kernels.sync_search_blockmax_ref(seg, tpl, n, te),), (), (0,))
            if not torch.equal(bm.amax(-1), q):
                raise AssertionError(f"sync_search_blockmax ({label}): its maximum is not the search's best")
            corr, want = kernels.correlate_fused(seg, tpl, n), kernels.correlate_fused_ref(seg, tpl, n)
            scale = float(want.square().mean().sqrt())
            errs["correlate_fused"] = compare(f"correlate_fused slab ({label})", (corr,), (want,), (), (0,),
                                              atol=RTOL * scale)
            del q, rq, bm, corr, want
            torch.cuda.empty_cache()
            calls = {
                "sync_search_fused": lambda f: f(seg, tpl, n, te),
                "sync_search_blockmax": lambda f: f(seg, tpl, n, te),
                "correlate_fused": lambda f: f(seg, tpl, n),
            }
            out_bytes = {"sync_search_fused": 8, "sync_search_blockmax": 4 * n // 128, "correlate_fused": 4 * n}
            # correlate_fused's one PyTorch call: a float32 convolution (cuDNN, TF32 off)
            seg_f32, weight = seg.float()[:, None, :], tpl.float()[None, None, :]
            library = {"correlate_fused": lambda: torch.nn.functional.conv1d(seg_f32, weight)}
            for name, call in calls.items():
                r = {"max_abs_err": errs[name], "ms": time_ms(lambda: call(getattr(kernels, name))),
                     "plain_ms": time_ms(lambda: call(getattr(kernels, f"{name}_ref"))),
                     "library_ms": time_ms(library[name]) if name in library else None}
                torch.cuda.empty_cache()
                r["bound_ms"], r["bound_by"] = bound_ms(b * ((n + k - 1) * seg.element_size() + out_bytes[name]),
                                                        2 * k * n * b)
                r["occupancy"] = kernels.search_slab_occupancy(name, seg_dtype, tpl_dtype, k, n)
                lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.3f} ms"
                log(f"  {name} slab ({label}, B {b}, out_len {n}): kernel {r['ms']:.3f} ms, plain "
                    f"{r['plain_ms']:.3f} ms{lib}, bound {r['bound_ms']:.3f} ms ({r['bound_by']}); {occupancy(r)}")
                out[name][label] = r
            del seg, seg_f32
            torch.cuda.empty_cache()
        del buf, idx
    out["sync_search_fused"]["stream-slow-f32"] = phase_search_slow(gen)
    return out


def phase_search_slow(gen) -> dict:
    """sync_search_fused on the slab route at stream-slow-f32's own shape:
    float32 segments of SLOW_STREAM_B streams of noise with
    SLOW_STREAM_CONFIG's 15,360-sample float32 preamble planted at a random
    lag among its chunk's out_len lags, strided from sample 1 as the
    stream's buffer slice is: the lags equal to the plain version's and the
    planted ones, the qualities within RTOL; timed with its plain version
    against its bound as phase_kernels_search_long counts it (the segment
    read once, 8 bytes a stream written, 2 k out_len B operations at the
    bf16 peak), with the slab kernel's occupancy (logged)."""
    cfg, b = SLOW_STREAM_CONFIG, SLOW_STREAM_B
    n = family.frame_samples(cfg, PAYLOAD) // 128 * 128  # phase_stream's chunk: the search's out_len
    t = preamble_waveform(cfg, device=DEV).float()
    k = t.shape[-1]
    lags = torch.randint(0, n, (b,), generator=gen, device=DEV)
    buf = 0.3 * torch.randn(b, n + k + 40, generator=gen, device=DEV)
    buf.scatter_add_(1, 1 + lags[:, None] + torch.arange(k, device=DEV), t.expand(b, k))
    seg = buf[:, 1 : n + k]
    te = float((t * t).sum())
    label = f"sync_search_fused slab (stream-slow-f32, k {k} float32/float32, B {b}, out_len {n})"
    q, i = kernels.sync_search_fused(seg, t, n, te)
    rq, ri = kernels.sync_search_fused_ref(seg, t, n, te)
    if not (torch.equal(i, ri) and torch.equal(i, lags.int())):
        raise AssertionError(f"{label}: lags differ in {int((i != ri).sum())} streams")
    r = {"max_abs_err": compare(label, (q,), (rq,), (), (0,))}
    del q, rq
    torch.cuda.empty_cache()
    call = lambda f: f(seg, t, n, te)  # noqa: E731
    r.update(ms=time_ms(lambda: call(kernels.sync_search_fused)),
             plain_ms=time_ms(lambda: call(kernels.sync_search_fused_ref)), library_ms=None, B=b, k=k, out_len=n)
    torch.cuda.empty_cache()
    r["bound_ms"], r["bound_by"] = bound_ms(b * ((n + k - 1) * 4 + 8), 2 * k * n * b)
    r["occupancy"] = kernels.search_slab_occupancy("sync_search_fused", torch.float32, torch.float32, k, n)
    log(f"  {label}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
        f"({r['bound_by']}); {occupancy(r)}")
    del seg, buf
    torch.cuda.empty_cache()
    return r


def phase_search_blockmax(cfg, gen) -> None:
    """"search-blockmax": the cold stream's acquisition segment (B = 8,192
    streams of phase 4's layout, bf16, slid into a fresh carry chunk by
    chunk as the stream step does, up to the chunk in which the first frame
    completes), its block maxima (sync_search_blockmax) held against the
    fused search (sync_search_fused) on the same segment: the maximum over
    blocks within rtol 1e-3 of the best quality, the winning block holding
    the best lag wherever no two blocks tie, that lag the planted one."""
    t_frame = family.frame_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    pay = torch.randint(0, 256, (STREAM_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    cap = torch.zeros(STREAM_B, 2 * chunk, dtype=torch.bfloat16, device=DEV)
    cap[:, GAP0 : GAP0 + t_frame] = family.transmit_fn(cfg, DEV)(pay).to(torch.bfloat16)
    carry = init_carry(cfg, chunk, PAYLOAD, (STREAM_B,), dtype=torch.bfloat16, device=DEV)
    for i in range(2):
        buffer, seen, w0, abs0 = _slide_buffer(carry, cap[:, i * chunk : (i + 1) * chunk], t_frame, 0)
        carry = carry._replace(buffer=buffer, samples_seen=seen)
    del cap
    tpl = preamble_waveform(cfg, device=DEV).to(torch.bfloat16)
    k = tpl.shape[-1]
    te = float((tpl.float() ** 2).sum())
    seg = buffer[:, w0 : w0 + chunk + k - 1]
    bm = kernels.sync_search_blockmax(seg, tpl, chunk, te)
    best_q, best_i = kernels.sync_search_fused(seg, tpl, chunk, te)
    top = bm.amax(-1, keepdim=True)
    untied = (bm == top).sum(-1) == 1
    planted = GAP0 - int(abs0[0]) - w0
    right = (bool(((top[:, 0] - best_q).abs() <= 1e-3 * best_q).all())
             and torch.equal(bm.argmax(-1)[untied].int(), best_i[untied] // 128)
             and bool((best_i == planted).all()))
    log(f"search-blockmax: B {STREAM_B}, out_len {chunk}, {bm.shape[1]} blocks, untied {int(untied.sum())}, "
        f"block maxima right {right}")
    if not right:
        raise AssertionError("search-blockmax: block maxima disagree with the fused search")


# --- the channel and the model helpers -----------------------------------------

# The reference's default SNR and its multipath docstring's echo (one echo 3
# samples after the direct path, at half amplitude).
CHANNEL = ChannelConfig(snr_db=10.0, multipath_taps=(1.0, 0.0, 0.0, 0.5))
SNR_DB_TOL = 0.1  # the measured SNR of the added noise against the target
ECHO_DELAY = len(CHANNEL.multipath_taps) - 1
CLASSIFY_MODELS = ("mfsk16-fast", "mfsk4-coded", "fsk2-robust", "ofdm-fast")


def classify_channelled(gen) -> None:
    """classify_capture(payload_len=256) on one capture of each of
    CLASSIFY_MODELS: one frame at a random start below 2,000, 4,000 samples
    of silence after it, through CHANNEL's echo at 10 dB or the preset's
    operating SNR plus 6 dB, whichever is higher (ofdm-fast: 20 dB). Each
    must come out named first with its header checked (the OFDM presets
    share one preamble: only the header check names ofdm-fast), located at
    its start or at most the echo's delay after it (the half-amplitude echo
    pulls the matched filter's peak toward itself)."""
    for name in CLASSIFY_MODELS:
        cfg = get_model(name).config
        pay = torch.randint(0, 256, (1, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
        w = family.transmit_fn(cfg, DEV)(pay)[0]
        start = int(torch.randint(0, 2000, (1,), generator=gen, device=DEV))
        cap = torch.zeros(start + w.shape[0] + 4000, device=DEV)
        cap[start : start + w.shape[0]] = w
        snr = max(CHANNEL.snr_db, OPERATING_SNR_DB[name] + 6.0)
        cap = apply_channel(gen, cap[None], dataclasses.replace(CHANNEL, snr_db=snr), device=DEV)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranked = classify_capture(cap, payload_len=PAYLOAD, device=DEV)
        dt = time.perf_counter() - t0
        top = ", ".join(f"{c.name} q {c.quality:.4f} at {c.offset} header {c.header_ok}" for c in ranked[:3])
        log(f"  classify_capture ({name} at {snr:.1f} dB, capture {cap.shape[0]}): {top}; {dt:.3f} s")
        first = ranked[0]
        if (first.name, first.header_ok) != (name, True) or not 0 <= first.offset - start <= ECHO_DELAY:
            raise AssertionError(f"classify_capture named {first} for a {name} frame at {start}")


def phase_aligned_channel(cfg, gen, iters: int = 5) -> None:
    """"aligned-channel": the aligned receiver's 16,384 frames,
    batch-major on the card, through apply_channel(CHANNEL) on the card,
    then time-major bf16 into demodulate_frame_tm (decide_frame_tm): every
    frame ok with its payload, and the measured SNR of the added noise
    (mean over streams of each stream's echoed-signal power over its noise
    power) within SNR_DB_TOL of the target. The link-adaptation rule on the
    batch's mean snr_db (family.waveform_snr_db, models.suggest_model) is
    printed; the classifier runs on four channelled presets
    (classify_channelled)."""
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    pay = torch.randint(0, 256, (ALIGNED_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    waves = transmit(cfg, pay, device=DEV)
    x = apply_channel(gen, waves, CHANNEL, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply_channel(gen, waves, CHANNEL, device=DEV)  # a second call, timed
    torch.cuda.synchronize()
    t_chan = time.perf_counter() - t0
    echoed = multipath(waves, CHANNEL.multipath_taps, device=DEV)
    del waves
    snr = 10 * torch.log10((echoed * echoed).mean(-1) / ((x - echoed) ** 2).mean(-1))
    snr_mean = float(snr.mean())
    del echoed
    x_tm = x.to(torch.bfloat16).T.contiguous()  # one untimed ingest cast
    del x
    res = tframe.demodulate_frame_tm(cfg, x_tm, PAYLOAD, device=DEV)
    ok_frac = float(res.ok.float().mean())
    right = torch.equal(res.payload, pay)
    snr_est = float(res.snr_db.mean())
    suggested = suggest_model(float(family.waveform_snr_db(cfg, snr_est)))
    log(f"aligned-channel: B {ALIGNED_B}, channel {CHANNEL.snr_db} dB + echo {CHANNEL.multipath_taps} "
        f"({ALIGNED_B * t_frame / t_chan / 1e6:.1f} Msamples/s through apply_channel); measured SNR mean "
        f"{snr_mean:.4f} dB (streams {float(snr.min()):.3f}-{float(snr.max()):.3f}); frames_ok_fraction {ok_frac}, "
        f"payloads right {right}; mean snr_db {snr_est:.3f} (waveform "
        f"{float(family.waveform_snr_db(cfg, snr_est)):.3f} dB): suggest_model {suggested.name}")
    if ok_frac != 1.0 or not right or abs(snr_mean - CHANNEL.snr_db) > SNR_DB_TOL:
        raise AssertionError(f"aligned-channel: frames_ok_fraction {ok_frac}, payloads right {right}, "
                             f"measured SNR {snr_mean} against {CHANNEL.snr_db} dB")
    del res, snr
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        n_ok = tframe.demodulate_frame_tm(cfg, x_tm, PAYLOAD, device=DEV).ok.sum()
    int(n_ok)
    dt = time.perf_counter() - t0
    log(f"aligned-channel: {ALIGNED_B * t_frame * iters / dt / 1e6:.1f} Msamples/s "
        f"({dt / iters * 1e3:.2f} ms/batch)")
    del x_tm
    torch.cuda.empty_cache()
    classify_channelled(gen)


# --- the OFDM family -----------------------------------------------------------

OFDM_OPS_POINT = 110  # float32 operations a point of ofdm_track_decide_fused (QPSK): two fit
# passes (~22 each), the gate pass (~37), the LLR and EVM pass (~25); sin and cos one each
OFDM_DYNAMIC_LENS = (64, 256, 128)


def resample_ppm(w: torch.Tensor, ppm: torch.Tensor) -> torch.Tensor:
    """Each row of w [B, T] as a receiver whose clock is ppm[b] parts per
    million off samples it: the row's DFT interpolant (band-limited, exact)
    evaluated at t (1 + ppm 1e-6), zero past the row's end; float64 on the
    card, one row at a time."""
    n = w.shape[-1]
    coef = torch.fft.rfft(w.double(), dim=-1)
    coef[..., 1:-1] *= 2
    k = torch.arange(coef.shape[-1], device=w.device, dtype=torch.float64)
    out = torch.empty_like(w)
    for b in range(w.shape[0]):
        t = torch.arange(n, device=w.device, dtype=torch.float64) * (1 + float(ppm[b]) * 1e-6)
        ang = (2 * np.pi / n) * torch.outer(t, k)
        row = (torch.polar(torch.ones_like(ang), ang) @ coef[b]).real / n
        out[b] = torch.where(t < n, row, 0.0).float()
    return out


def drifted_frames(cfg, gen, ppm: torch.Tensor):
    """(payloads [n, PAYLOAD], frames float32 [n, T]): one frame a clock
    offset of ``ppm`` [n], with white noise at the constellation's SNR
    (OFDM_SNR_DB, against each frame's own power)."""
    n = ppm.shape[0]
    pay = torch.randint(0, 256, (n, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    x = resample_ppm(family.transmit_fn(cfg, DEV)(pay), ppm)
    snr = OFDM_SNR_DB[{2: "ofdm-fast", 4: "ofdm-turbo", 6: "ofdm-max"}[cfg.bits_per_carrier]]
    sigma = ((x * x).mean(-1, keepdim=True) * 10 ** (-snr / 10)).sqrt()
    return pay, x + sigma * torch.randn(x.shape, generator=gen, device=DEV)


def ofdm_equalizer_inputs(cfg, x: torch.Tensor):
    """(z_eq, h_pow, slope0) of the OFDM receiver's front on aligned frames."""
    s_data = cfg.data_symbols_for_payload(PAYLOAD)
    carriers = ofdm._extract_carriers(cfg, x[:, cfg.preamble_samples :], 1 + s_data)
    z_eq, h_pow = ofdm._equalize(cfg, carriers)
    return z_eq, h_pow, ofdm.preamble_phase_slope(cfg, x)


def compare_ofdm(label: str, cfg, got, want, drifted: torch.Tensor) -> float:
    """Hold the kernel's (llrs, evm2, coherences) against the plain
    version's. The identity gate compares two coherences that a clean-clock
    frame ties in the last digits, so a stream's LLRs may part (a small
    rotation) only where the plain version's two coherences lie within
    GATE_EPS, never on a drifted frame and never untracked. Elsewhere: LLRs
    within OFDM_RTOL of their scale, their signs (the decisions) equal
    wherever the plain LLR lies outside that band, evm2 within OFDM_RTOL;
    the coherences everywhere. Returns the max abs error of LLRs and evm2."""
    llrs, ref = got[0], want[0]
    atol = OFDM_RTOL * float(ref.abs().max())
    diff = (llrs - ref).abs()
    close = (diff <= OFDM_RTOL * ref.abs() + atol).all(-1)
    parted = ~close
    tie = (want[2][:, 0] - want[2][:, 1]).abs() < GATE_EPS
    if bool((parted & (drifted | ~tie)).any()) or (not cfg.clock_tracking and bool(parted.any())):
        raise AssertionError(f"{label}: LLRs of {int(parted.sum())} streams part from the plain version's "
                             f"({int((parted & drifted).sum())} drifted)")
    firm = ref[close].abs() > atol
    flips = int(((llrs[close] > 0) != (ref[close] > 0))[firm].sum())
    evm_err = (got[1] - want[1]).abs()[close]
    if flips or bool((evm_err > OFDM_RTOL * want[1][close].abs()).any()):
        raise AssertionError(f"{label}: {flips} decisions differ, or evm2 beyond rtol {OFDM_RTOL}")
    if bool(((got[2] - want[2]).abs() > OFDM_RTOL * want[2].abs() + 1e-6).any()):
        raise AssertionError(f"{label}: the gate's coherences differ beyond rtol {OFDM_RTOL}")
    err = max(float(diff[close].max()), float(evm_err.max()))
    log(f"  {label}: max abs {err:.3e}; streams parted at a gate tie {int(parted.sum())}, decisions differing 0")
    return err


def phase_kernels_ofdm(gen) -> dict:
    """Phase 2 for the OFDM equalizer: ofdm_track_decide_fused against its
    plain version on 256 frames of each constellation (224 drifted by
    100-150 ppm either way, 32 on a clean clock), tracked and untracked;
    then both timed on ofdm-fast at B = 8,192 (the frames tiled)."""
    worst, timed = 0.0, None
    n_clean = 32
    for model in OFDM_QAM_MODELS:
        base = get_model(model).config
        n_drift = COMPARE_B - n_clean
        sign = torch.where(torch.rand(n_drift, generator=gen, device=DEV) < 0.5, -1.0, 1.0).double()
        mag = 100.0 + 50.0 * torch.rand(n_drift, generator=gen, device=DEV, dtype=torch.float64)
        ppm = torch.cat([sign * mag, torch.zeros(n_clean, device=DEV, dtype=torch.float64)])
        _, x = drifted_frames(base, gen, ppm)
        for cfg in (base, dataclasses.replace(base, clock_tracking=False)):
            z_eq, h_pow, slope0 = ofdm_equalizer_inputs(cfg, x)
            got = kernels.ofdm_track_decide_fused(cfg, z_eq, h_pow, slope0, with_coherence=True)
            want = kernels.ofdm_track_decide_fused_ref(cfg, z_eq, h_pow, slope0, with_coherence=True)
            label = f"ofdm_track_decide_fused ({model}, {'tracked' if cfg.clock_tracking else 'untracked'})"
            worst = max(worst, compare_ofdm(label, cfg, got, want, ppm.abs() >= 100))
            if model == OFDM_MODEL and cfg.clock_tracking:
                timed = (cfg, z_eq, h_pow, slope0)
    cfg, z_eq, h_pow, slope0 = timed
    reps = STREAM_B // COMPARE_B
    z_full, h_full, s_full = z_eq.repeat(reps, 1, 1), h_pow.repeat(reps, 1), slope0.repeat(reps)
    results = {"ofdm_track_decide_fused": {"max_abs_err": worst}}
    calls = {
        "ofdm_track_decide_fused": (
            lambda f: f(cfg, z_full, h_full, s_full),
            kernels.ofdm_track_decide_fused, kernels.ofdm_track_decide_fused_ref,
        ),
    }
    b, (n_s, n_c) = STREAM_B, z_eq.shape[1:]
    in_bytes = b * (n_s * n_c * 8 + n_c * 4 + 4)
    out_bytes = b * (n_s * n_c * cfg.bits_per_carrier * 4 + 4)
    work = {"ofdm_track_decide_fused": (in_bytes + out_bytes, b * n_s * n_c * OFDM_OPS_POINT, F32_FLOPS_S)}
    log(f"ofdm geometry: {n_s} data symbols x {n_c} carriers, B {b}")
    time_and_bound(results, calls, work)
    # the time-major receiver's layout: the [B, S, C] view of [S, C, B]
    # points and of [C, B] channel powers (point stride 1), the same values
    z_tm, h_tm = z_full.permute(1, 2, 0).contiguous().permute(2, 0, 1), h_full.T.contiguous().T
    got_tm = kernels.ofdm_track_decide_fused(cfg, z_tm, h_tm, s_full)
    got_bm = kernels.ofdm_track_decide_fused(cfg, z_full, h_full, s_full)
    if not (torch.equal(got_tm[0], got_bm[0]) and torch.equal(got_tm[1], got_bm[1])):
        raise AssertionError("ofdm_track_decide_fused: the time-major view gives other bits than batch-major")
    del got_tm, got_bm
    ms = time_ms(lambda: kernels.ofdm_track_decide_fused(cfg, z_tm, h_tm, s_full))
    log(f"  ofdm_track_decide_fused (time-major view: B {b}): kernel {ms:.3f} ms, "
        f"bound {results['ofdm_track_decide_fused']['bound_ms']:.3f} ms")
    del z_tm, h_tm
    # the search at the OFDM stream's geometry (stream-ofdm's chunk and
    # preamble), on noise: a timing only
    chunk = family.frame_samples(cfg, PAYLOAD) // 128 * 128
    tpl = family.preamble_template(cfg, DEV).to(torch.bfloat16)
    seg = torch.randn(b, chunk + tpl.shape[-1] - 1, generator=gen, device=DEV).to(torch.bfloat16)
    log_search_time("OFDM stream geometry", seg, tpl, chunk)
    return results


OFDM_LONG_MODEL = "ofdm-coded"
OFDM_LONG_PAYLOAD = 4096  # 343 data symbols of 96 carriers: past the staged route's 302
OFDM_LONG_B = 1024  # the long-frame paths' batch and phase 2's batch for the block route
OFDM_4K_MODEL = "ofdm-fast"  # 4,096-byte frames: 172 data symbols, one warp an SM on the staged route
# ofdm-coded frames of 1,024 bytes (87 data symbols), ofdm-fast of 4,096 (172), the staged
# route's longest (302), then streams past it (303; 343, a 4,096-byte ofdm-coded frame)
OFDM_LONG_SYMBOLS = (87, 172, 302, 303, 343)


def ofdm_route_key(route: str) -> str:
    """The launch-count key of an ofdm_track_decide_fused launch on
    ``route`` (kernels._ofdm_track_route's names)."""
    return "ofdm_track_decide_fused" + ("" if route == "staged" else f":{route}")


def long_ofdm_points(cfg, gen, b: int, s_n: int):
    """(z_eq complex64 [b, S, C], h_pow float32 [b, C], slope0 float32 [b],
    drifted bool [b]) of S = s_n data symbols, made on the card as the
    equalizer sees them: constellation points rotated by the drift phase c
    (s + 1) m of 100-150 ppm either way (every fourth stream on a clean
    clock, c = 0: the gate near a tie), noise at the constellation's SNR
    (OFDM_SNR_DB), channel powers in [0.5, 1.5], slope0 within 5% of c.
    (Resampling frames of 300-odd symbols as drifted_frames does would
    take minutes.)"""
    bpc, c_n = cfg.bits_per_carrier, cfg.n_carriers
    scale = {2: kernels._QPSK_AMP, 4: kernels._QAM16_SCALE, 6: kernels._QAM64_SCALE}[bpc]
    half = 1 << (bpc // 2 - 1)  # levels on either side of 0 an axis
    lv = (2 * torch.arange(half, device=DEV, dtype=torch.float64) + 1) * scale
    lv = torch.cat([lv, -lv])

    def axis():
        return lv[torch.randint(0, 2 * half, (b, s_n, c_n), generator=gen, device=DEV)]

    drifted = torch.arange(b, device=DEV) % 4 != 3
    sign = torch.where(torch.rand(b, generator=gen, device=DEV) < 0.5, -1.0, 1.0).double()
    ppm = torch.where(drifted, sign * (100.0 + 50.0 * torch.rand(b, generator=gen, device=DEV).double()), 0.0)
    slope = ppm * 1e-6 * 2 * np.pi * cfg.symbol_samples / cfg.n_fft
    m = cfg.first_carrier + torch.arange(c_n, device=DEV, dtype=torch.float64)
    ang = slope[:, None, None] * torch.arange(1, s_n + 1, device=DEV, dtype=torch.float64)[None, :, None] * m
    snr = OFDM_SNR_DB[{2: "ofdm-fast", 4: "ofdm-turbo", 6: "ofdm-max"}[bpc]]
    sigma = 10 ** (-snr / 20) / np.sqrt(2)
    noise = torch.complex(torch.randn(ang.shape, generator=gen, device=DEV, dtype=torch.float64),
                          torch.randn(ang.shape, generator=gen, device=DEV, dtype=torch.float64))
    z = (torch.complex(axis(), axis()) * torch.polar(torch.ones_like(ang), ang) + sigma * noise).to(torch.complex64)
    del ang, noise
    h_pow = (0.5 + torch.rand(b, c_n, generator=gen, device=DEV)).float()
    slope0 = (slope * (0.95 + 0.1 * torch.rand(b, generator=gen, device=DEV).double())).float()
    return z, h_pow, slope0, drifted


@contextlib.contextmanager
def forced_ofdm_route(route: str):
    """Inside the block, every ofdm_track_decide_fused launch takes
    ``route`` whatever its shapes: the staged route held and timed at a
    shape the block route takes."""
    saved = kernels._ofdm_track_route
    kernels._ofdm_track_route = lambda s, c: route
    try:
        yield
    finally:
        kernels._ofdm_track_route = saved


def block_issue_ms_a_point() -> float:
    """The block route's arithmetic floor a point of a drifted, tracked QPSK
    stream, in ms, read from the SASS of the library this run built
    (anet_torch.kernels.sass_mix.loops on ofdm_track_block_kernel<2, 1>):
    the instructions of its first three loops off sincosf's slow path (the
    two fit passes and the gate pass, each 4 points a trip: ``#pragma
    unroll`` in csrc/ofdm_track.cu), a lane a point, 32 points a warp
    instruction, issued at one a clock by each of an SM's 4 schedulers on
    132 SMs at the card's top SM clock (nvidia-smi clocks.max.sm)."""
    from anet_torch.kernels.sass_mix import instruction_mix

    (row,) = [r for r in instruction_mix("ofdm_track", with_loops=True)
              if r["function"].startswith("void <unnamed>::ofdm_track_block_kernel<(int)2, (int)1>")]
    if len(row["loops"]) < 3:
        raise AssertionError(f"ofdm_track_block_kernel<2, 1>: loops {row['loops']}, not the three passes")
    per_point = sum(loop[3] for loop in row["loops"][:3]) / 4
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    log(f"  ofdm_track_block_kernel<2, 1>: {per_point:g} instructions a point in its fit and gate passes (SASS), "
        f"{mhz:g} MHz")
    return per_point / 32 / (132 * 4 * mhz * 1e6) * 1e3


def phase_kernels_ofdm_long(gen) -> dict:
    """Phase 2 for the OFDM equalizer on long frames: ofdm_track_decide_fused
    on ofdm-coded (QPSK, tracked) streams of OFDM_LONG_SYMBOLS data symbols
    (a 1,024-byte frame, a 4,096-byte ofdm-fast one's 172, the staged
    route's longest 302, then 303 and a 4,096-byte ofdm-coded frame's 343),
    B = OFDM_LONG_B (long_ofdm_points), batch-major and as the time-major
    receiver's [B, S, C] view of [S, C, B] points: each launch on the route
    kernels._ofdm_track_route names (the block route at every one; one
    count under its key), held against the plain version with compare_ofdm's
    rules, both layouts bit-equal, and timed with the plain version against
    its bound (the points read once, the LLRs written once) and the block
    route's arithmetic floor (block_issue_ms_a_point, logged); the staged
    route, forced where a stream fits (S <= 302), held by the same rules and
    timed beside it. The ":block" results: S = 343 batch-major, the other
    shapes, layouts and routes under "shapes"."""
    cfg = get_model(OFDM_LONG_MODEL).config
    b, c_n, bpc = OFDM_LONG_B, cfg.n_carriers, cfg.bits_per_carrier
    shapes, worst = {}, 0.0
    ms_a_point = block_issue_ms_a_point()
    for s_n in OFDM_LONG_SYMBOLS:
        route = kernels._ofdm_track_route(s_n, c_n)
        if route != "block":
            raise AssertionError(f"ofdm_track_decide_fused: S = {s_n} takes the {route} route")
        key = ofdm_route_key(route)
        z, h, sl, drifted = long_ofdm_points(cfg, gen, b, s_n)
        z_tm, h_tm = z.permute(1, 2, 0).contiguous().permute(2, 0, 1), h.T.contiguous().T
        want = kernels.ofdm_track_decide_fused_ref(cfg, z, h, sl, with_coherence=True)
        before = dict(kernels.launch_counts)
        got = kernels.ofdm_track_decide_fused(cfg, z, h, sl, with_coherence=True)
        got_tm = kernels.ofdm_track_decide_fused(cfg, z_tm, h_tm, sl, with_coherence=True)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in kernels.launch_counts.items() if v != before[k]}
        if launched != {key: 2}:
            raise AssertionError(f"ofdm_track_decide_fused (S {s_n}): launches {launched}, not two under {key}")
        label = f"ofdm_track_decide_fused ({route}, {OFDM_LONG_MODEL}, S {s_n}, B {b})"
        worst = max(worst, compare_ofdm(label, cfg, got, want, drifted))
        if not all(torch.equal(g, t) for g, t in zip(got, got_tm)):
            raise AssertionError(f"{label}: the time-major view gives other bits than batch-major")
        fits = kernels._ofdm_staged_warps(s_n, c_n) > 0
        if fits:
            with forced_ofdm_route("staged"), uncounted():
                staged = kernels.ofdm_track_decide_fused(cfg, z, h, sl, with_coherence=True)
            compare_ofdm(f"ofdm_track_decide_fused (staged, forced, S {s_n}, B {b})", cfg, staged, want, drifted)
            del staged
        del got, got_tm, want
        points = b * s_n * c_n * 8
        in_bytes, out_bytes = points + b * (c_n * 4 + 4), b * (s_n * c_n * bpc * 4 + 4)
        bound, by = bound_ms(in_bytes + out_bytes, b * s_n * c_n * OFDM_OPS_POINT, F32_FLOPS_S)
        floor = b * s_n * c_n * ms_a_point
        runs = [(route, "batch-major", z, h), (route, "time-major", z_tm, h_tm)]
        if fits:
            runs += [("staged", "batch-major", z, h)]
        for rt, layout, zz, hh in runs:
            with forced_ofdm_route(rt):
                r = {"route": rt, "ms": time_ms(lambda: kernels.ofdm_track_decide_fused(cfg, zz, hh, sl))}
            r.update(bound_ms=bound, bound_by=by, library_ms=None)
            if layout == "batch-major" and rt == route:
                r["plain_ms"] = time_ms(lambda: kernels.ofdm_track_decide_fused_ref(cfg, z, h, sl))
            plain = f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else ""
            issue = f", its issue floor {floor:.3f} ms" if rt == "block" else ""
            log(f"  ofdm_track_decide_fused ({rt} route, {layout}, S {s_n}, B {b}): kernel {r['ms']:.3f} ms{plain}, "
                f"bound {bound:.3f} ms ({by}){issue}")
            shapes[f"S {s_n} {rt} {layout}"] = r
        del z, z_tm, h, h_tm
        torch.cuda.empty_cache()
    top = shapes.pop(f"S {OFDM_LONG_SYMBOLS[-1]} block batch-major")
    return {"ofdm_track_decide_fused:block": {"max_abs_err": worst, **top, "model": OFDM_LONG_MODEL,
                                              "B": b, "symbols": OFDM_LONG_SYMBOLS[-1], "shapes": shapes}}


def phase_aligned_ofdm_long(cfg, gen, label: str, iters: int = 3) -> None:
    """"aligned-ofdm-long" and "aligned-ofdm-4k": OFDM_LONG_B frames of
    OFDM_LONG_PAYLOAD bytes (ofdm-coded: 343 data symbols, past the staged
    route; ofdm-fast: 172, where the staged route kept one warp an SM),
    transmitted on the card at 16 dB on a clean clock, through
    family.aligned_demod_fn batch-major and through ofdm.demodulate_frame_tm
    on the same frames time-major: the equalizer on the route
    kernels._ofdm_track_route names (the block route; the path's kernels and
    ABSENT hold it), and viterbi_trellis where the preset is coded; every
    frame ok with the payload sent, both layouts."""
    pay = torch.randint(0, 256, (OFDM_LONG_B, OFDM_LONG_PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    x = family.transmit_fn(cfg, DEV)(pay)
    sigma = ((x * x).mean(-1, keepdim=True) * 10 ** (-OFDM_SNR_DB["ofdm-fast"] / 10)).sqrt()
    x = x + sigma * torch.randn(x.shape, generator=gen, device=DEV)
    x_tm = x.T.contiguous()  # one untimed ingest transpose
    aligned_fn = family.aligned_demod_fn(cfg, OFDM_LONG_PAYLOAD, device=DEV)
    t_frame = cfg.frame_num_samples(OFDM_LONG_PAYLOAD)
    for layout, demod in (("batch-major", lambda: aligned_fn(x)),
                          ("time-major", lambda: ofdm.demodulate_frame_tm(cfg, x_tm, OFDM_LONG_PAYLOAD, device=DEV))):
        res = demod()
        ok_frac = float(res.ok.float().mean())
        if ok_frac != 1.0 or not torch.equal(res.payload, pay):
            raise AssertionError(f"{label} ({layout}): frames_ok_fraction {ok_frac}, payloads equal "
                                 f"{torch.equal(res.payload, pay)}")
        del res
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            n_ok = demod().ok.sum()
        int(n_ok)
        dt = time.perf_counter() - t0
        log(f"{label} ({layout}): B {OFDM_LONG_B}, payload {OFDM_LONG_PAYLOAD}, "
            f"{cfg.data_symbols_for_payload(OFDM_LONG_PAYLOAD)} data symbols, frames_ok_fraction {ok_frac}, "
            f"{OFDM_LONG_B * t_frame * iters / dt / 1e6:.1f} Msamples/s ({dt / iters * 1e3:.2f} ms/batch)")


@functools.lru_cache(maxsize=1)
def aligned_ofdm_frames(cfg, batch: int):
    """(payloads, float32 frames [batch, T]): OFDM_DISTINCT distinct frames,
    each at its own clock offset in +-OFDM_PPM, tiled to ``batch``; made once
    from their own seed, so the batch- and time-major paths get the same."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    ppm = (2 * torch.rand(OFDM_DISTINCT, generator=gen, device=DEV, dtype=torch.float64) - 1) * OFDM_PPM
    pay, x = drifted_frames(cfg, gen, ppm)
    reps = batch // OFDM_DISTINCT
    return pay.repeat(reps, 1), x.repeat(reps, 1)


def phase_aligned_ofdm(cfg, label: str, batch: int, time_major: bool = False, iters: int = 5) -> None:
    """Phase 7: the aligned OFDM receiver at full batch, batch-major through
    family.aligned_demod_fn or time-major through ofdm.demodulate_frame_tm."""
    pay, x = aligned_ofdm_frames(cfg, batch)
    if time_major:
        x = x.T.contiguous()  # one untimed ingest transpose

        def demod():
            return ofdm.demodulate_frame_tm(cfg, x, PAYLOAD, device=DEV)
    else:
        aligned_fn = family.aligned_demod_fn(cfg, PAYLOAD, device=DEV)

        def demod():
            return aligned_fn(x)

    res = demod()
    ok_frac = float(res.ok.float().mean())
    if ok_frac != 1.0 or not torch.equal(res.payload, pay):
        raise AssertionError(f"{label}: frames_ok_fraction {ok_frac}, payloads equal {torch.equal(res.payload, pay)}")
    del res
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        n_ok = demod().ok.sum()
    int(n_ok)
    dt = time.perf_counter() - t0
    t_frame = cfg.frame_num_samples(PAYLOAD)
    log(f"{label}: B {batch}, frames_ok_fraction {ok_frac}, "
        f"{batch * t_frame * iters / dt / 1e6:.1f} Msamples/s ({dt / iters * 1e3:.2f} ms/batch)")


def phase_oneshot_ofdm(cfg, gen) -> None:
    """Phase 7: ofdm.receive_frame on 2,048 bf16 captures of 8,192 samples,
    the frame at a random start below 2,000, noise 20 dB under the signal."""
    b, n, t = ONESHOT_B, 8192, cfg.frame_num_samples(PAYLOAD)
    starts = torch.randint(0, 2000, (b,), generator=gen, device=DEV)
    pay = torch.randint(0, 256, (b, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    cap = 0.0125 * torch.randn(b, n, generator=gen, device=DEV)  # the signal's rms is amplitude / 4
    cap.scatter_add_(1, starts[:, None] + torch.arange(t, device=DEV), ofdm.transmit(cfg, pay, device=DEV))
    cap = cap.to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ofdm.receive_frame(cfg, cap, PAYLOAD, device=DEV)
    n_ok = int(res.frame.ok.sum())
    dt = time.perf_counter() - t0
    right = torch.equal(res.offset, starts.int()) and torch.equal(res.frame.payload, pay)
    log(f"oneshot-ofdm receive_frame: B {b}, capture {n}, ok {n_ok}, offsets and payloads right {right}, "
        f"{b * n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")
    if n_ok != b or not right:
        raise AssertionError(f"oneshot-ofdm: ok {n_ok} of {b}, offsets and payloads right {right}")


# --- the scale-out layer and the modem CLI -------------------------------------

MESH_POSITIONS = 4  # positions of the sharded paths, all on the one card
LONG_CHUNKS = 4  # chunks a position of sharded-long
GRID_B, GRID_CHUNKS = 8192, 3  # sharded-grid: streams, chunks a time segment
DYN_GRID_B, DYN_SEG_CHUNKS = 2048, 5  # sharded-dynamic: grid streams, chunks a segment
SWEEP_FRAMES = 4096  # frames a point of ber-sweep
SWEEP_OFFSETS_DB = (-12.0, -6.0, 0.0, 6.0)  # around the preset's operating SNR
CAPTURE_SNR_DB = 14.0
CLI_PAYLOAD = 1024


def card_mesh(*shape: int) -> parallel.Mesh:
    """A mesh of ``shape`` positions (MESH_POSITIONS by default), every one
    on the card: the halo copies, counter sums and chunk order all run
    there."""
    shape = shape or (MESH_POSITIONS,)
    card = torch.device("cuda", 0) if DEV.type == "cuda" else DEV
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [card] * devices.size
    names = (parallel.STREAM_AXIS, parallel.TIME_AXIS)[: len(shape)]
    return parallel.Mesh(devices.reshape(shape), names)


def placed_capture(cfg, gen, starts: torch.Tensor, lens, n: int):
    """A float32 capture [B, n] on the card: white noise at CAPTURE_SNR_DB
    against the frames' power, plus frame j of every stream (``lens[j]``
    random bytes, header-declared) at starts[:, j]. The sharded paths hold
    their frames to the unsharded receiver's on it."""
    b = starts.shape[0]
    cap = torch.zeros(b, n, device=DEV)
    for j, length in enumerate(lens):
        pay = torch.randint(0, 256, (b, length), generator=gen, device=DEV, dtype=torch.uint8)
        waves = transmit(cfg, pay, device=DEV)
        cap.scatter_add_(1, starts[:, j : j + 1].long() + torch.arange(waves.shape[1], device=DEV), waves)
        del waves
    power = float((cap * cap).sum() / sum(b * tframe.dynamic_frame_samples(cfg, n_) for n_ in lens))
    cap += (power / 10 ** (CAPTURE_SNR_DB / 10)) ** 0.5 * torch.randn(b, n, generator=gen, device=DEV)
    return cap


def boundary_starts(gen, b: int, boundaries, lens, t_of, lo: float = 0.25, hi: float = 0.75) -> torch.Tensor:
    """int [b, len(boundaries)]: a frame of ``lens[j]`` bytes across each
    boundary, starting a seeded lo..hi share of its length before it."""
    cols = []
    for bound, length in zip(boundaries, lens):
        t = t_of(length)
        cols.append(bound - torch.randint(int(lo * t), int(hi * t), (b,), generator=gen, device=DEV))
    return torch.stack(cols, 1)


def same_detections(got, want, label: str, dynamic: bool = False) -> None:
    """A sharded run's steps [B, chunks, ...] (or [chunks, ...]) equal to the
    unsharded receiver's [chunks, B, ...]: detections, frame starts,
    payloads, verdicts (and declared lengths)."""
    fields = ("detected", "frame_start")
    frame_fields = ("payload", "ok") + (("payload_len",) if dynamic else ())
    det = want.detected
    mine = (lambda x: x.movedim(1, 0)) if got.detected.dim() == det.dim() and det.dim() > 1 else (lambda x: x)
    bad = [f for f in fields if not torch.equal(mine(getattr(got, f))[det], getattr(want, f)[det])]
    bad += [f for f in frame_fields if not torch.equal(mine(getattr(got.frame, f))[det], getattr(want.frame, f)[det])]
    if not torch.equal(mine(got.detected), det):
        bad.append("detected mask")
    if bad:
        raise AssertionError(f"{label}: differs from the unsharded receiver in {bad}")


def same_counts(got, want_carry, label: str) -> None:
    g = [int(got.frames_detected), int(got.frames_ok), int(got.decode_errors)]
    w = [int(want_carry.frames_detected.sum()), int(want_carry.frames_ok.sum()), int(want_carry.decode_errors.sum())]
    if g != w:
        raise AssertionError(f"{label}: counters {g} against the unsharded receiver's {w}")


def join_steps(r1, r2):
    """The steps of two super-steps of one stream joined along the chunk
    axis."""
    return type(r1.steps)(*(
        type(a)(*(torch.cat(p) for p in zip(a, b))) if isinstance(a, tuple) else torch.cat([a, b])
        for a, b in zip(r1.steps, r2.steps)
    ))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sharded_demod(cfg, gen) -> None:
    """"sharded-demod": 16,384 aligned mfsk16-fast frames (float32 compute,
    the reference's default) through parallel.sharded_demodulate on 4
    positions of the card, then on make_mesh() (every card, one position
    each): every frame ok, payloads and verdicts equal to one unsharded
    demodulate_frame call on the same batch (uncounted), whose own are
    those of the plain filterbank (plain_filterbank)."""
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    pay = torch.randint(0, 256, (ALIGNED_B, PAYLOAD), generator=gen, device=DEV, dtype=torch.uint8)
    waves = transmit(cfg, pay, device=DEV)
    with uncounted():
        ref, dt_ref = timed(lambda: tframe.demodulate_frame(cfg, waves, PAYLOAD, device=DEV))
    with plain_filterbank():
        if not same_verdicts(ref, tframe.demodulate_frame(cfg, waves, PAYLOAD, device=DEV)):
            raise AssertionError("sharded-demod: the unsharded call's payloads or verdicts differ from the plain "
                                 "filterbank's")
    for label, mesh in (("4 positions", card_mesh()), ("make_mesh()", parallel.make_mesh())):
        res, dt = timed(lambda: parallel.sharded_demodulate(cfg, mesh, waves, PAYLOAD))
        right = all(torch.equal(getattr(res, f), getattr(ref, f)) for f in ("payload", "ok", "magic_ok", "header_crc_ok"))
        n_ok = int(res.ok.sum())
        log(f"sharded-demod {label} ({mesh.devices.size} on {sorted({str(d) for d in mesh.devices.flat})}): "
            f"B {ALIGNED_B}, ok {n_ok}, payloads and verdicts equal to the unsharded call {right}, "
            f"{ALIGNED_B * t_frame / dt / 1e6:.1f} Msamples/s ({dt * 1e3:.2f} ms; the unsharded call "
            f"{ALIGNED_B * t_frame / dt_ref / 1e6:.1f}, {dt_ref * 1e3:.2f} ms)")
        if n_ok != ALIGNED_B or not right or not torch.equal(res.payload, pay):
            raise AssertionError(f"sharded-demod {label}: ok {n_ok}, equal to the unsharded call {right}")
        del res


def phase_ber_sweep(cfg, gen) -> None:
    """"ber-sweep": parallel.ber_sweep on 4 positions, payload 256, 4,096
    frames a point at the preset's operating SNR -12, -6, 0 and +6 dB:
    total_frames and total_bits exact at every point, BER non-increasing
    with SNR, FER 0 at the top point."""
    snrs = [OPERATING_SNR_DB[MODEL] + d for d in SWEEP_OFFSETS_DB]
    sweep_gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    pt, dt = timed(lambda: parallel.ber_sweep(cfg, card_mesh(), sweep_gen, snrs, SWEEP_FRAMES, PAYLOAD))
    ber, fer = pt.ber.tolist(), pt.fer.tolist()
    totals = pt.total_frames.tolist() == [SWEEP_FRAMES] * len(snrs) and pt.total_bits.tolist() == [
        SWEEP_FRAMES * PAYLOAD * 8
    ] * len(snrs)
    monotone = all(b <= a for a, b in zip(ber, ber[1:]))
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    log(f"ber-sweep: {len(snrs)} points x {SWEEP_FRAMES} frames, snr {snrs} dB: ber {ber}, fer {fer}; "
        f"totals right {totals}, BER non-increasing {monotone}; "
        f"{len(snrs) * SWEEP_FRAMES * t_frame / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")
    if not (totals and monotone and fer[-1] == 0.0):
        raise AssertionError(f"ber-sweep: totals {totals}, monotone {monotone}, top FER {fer[-1]}")


def phase_sharded_long(cfg, gen) -> None:
    """"sharded-long": one mfsk16-fast stream split along time over 4
    positions, 4 chunks each (chunk 36,352), frames at seeded offsets with
    one across each inner boundary, at 14 dB; parallel.
    sharded_receive_long_capture searching, then with lock=True, then as
    two super-steps joined by resume: frames, starts, payloads and counters
    equal to one unsharded receive_stream call in the same mode
    (uncounted), each boundary frame found once."""
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    seg = LONG_CHUNKS * chunk
    n = MESH_POSITIONS * seg
    edge = boundary_starts(gen, 1, [i * seg for i in range(1, MESH_POSITIONS)], [PAYLOAD] * 3, lambda _: t_frame)
    first = torch.randint(1000, 20000, (1, 1), generator=gen, device=DEV)
    last = (MESH_POSITIONS - 1) * seg + torch.randint(40000, 60000, (1, 1), generator=gen, device=DEV)
    starts = torch.cat([first, edge, last], 1)
    cap = placed_capture(cfg, gen, starts, [PAYLOAD] * starts.shape[1], n)
    cap = cap[0]
    truth = starts[0].tolist()
    mesh = card_mesh()
    for mode, lock in (("search", False), ("lock", True)):
        with uncounted():
            ref, dt_ref = timed(lambda: receive_stream(cfg, cap, chunk, PAYLOAD, lock=lock, device=DEV))
        res, dt = timed(lambda: parallel.sharded_receive_long_capture(cfg, mesh, cap, chunk, PAYLOAD, lock=lock))
        same_detections(res.steps, ref.steps, f"sharded-long {mode}")
        same_counts(res, ref.carry, f"sharded-long {mode}")
        found = res.steps.frame_start[res.steps.detected].tolist()
        if found != truth or int(res.frames_ok) != len(truth):
            raise AssertionError(f"sharded-long {mode}: frames at {found}, sent at {truth}, ok {int(res.frames_ok)}")
        log(f"sharded-long {mode}: {MESH_POSITIONS} positions x {LONG_CHUNKS} chunks of {chunk} ({n} samples), "
            f"frames at {truth} (boundaries at {[i * seg for i in range(1, MESH_POSITIONS)]}), ok "
            f"{int(res.frames_ok)}, equal to the unsharded receive_stream; {n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s; "
            f"unsharded {n / dt_ref / 1e6:.1f}, {dt_ref:.3f} s)")
        if mode == "search":
            search_ref = ref
    half = n // 2

    def two_steps():
        r1 = parallel.sharded_receive_long_capture(cfg, mesh, cap[:half], chunk, PAYLOAD)
        return r1, parallel.sharded_receive_long_capture(cfg, mesh, cap[half:], chunk, PAYLOAD, resume=r1.resume)

    (r1, r2), dt = timed(two_steps)
    same_detections(join_steps(r1, r2), search_ref.steps, "sharded-long resume")
    same_counts(r2, search_ref.carry, "sharded-long resume")
    if int(r2.resume.samples_seen) != n:
        raise AssertionError(f"sharded-long resume: samples_seen {int(r2.resume.samples_seen)} of {n}")
    log(f"sharded-long resume: two super-steps of {half} samples (a frame across the split at {half}), equal to the "
        f"single call; {n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s)")


def phase_sharded_grid(cfg, gen) -> None:
    """"sharded-grid": 8,192 mfsk16-fast streams over 2 x 2 positions
    (streams x time), 3 chunks a time segment (N = 218,112 samples, float32
    capture 7.1 GB), three frames a stream at seeded offsets, the second
    across the time boundary, at 14 dB: parallel.sharded_receive_capture_grid
    equal to one unsharded receive_stream call on the [8,192, N] capture
    (uncounted)."""
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    seg = GRID_CHUNKS * chunk
    n = 2 * seg
    b = GRID_B
    starts = torch.cat([
        torch.randint(500, 30000, (b, 1), generator=gen, device=DEV),
        boundary_starts(gen, b, [seg], [PAYLOAD], lambda _: t_frame),
        torch.randint(seg + t_frame - 2000, n - t_frame - 1000, (b, 1), generator=gen, device=DEV),
    ], 1)
    cap = placed_capture(cfg, gen, starts, [PAYLOAD] * 3, n)
    with uncounted():
        ref, dt_ref = timed(lambda: receive_stream(cfg, cap, chunk, PAYLOAD, device=DEV))
    torch.cuda.empty_cache()
    res, dt = timed(lambda: parallel.sharded_receive_capture_grid(cfg, card_mesh(2, 2), cap, chunk, PAYLOAD))
    same_detections(res.steps, ref.steps, "sharded-grid")
    same_counts(res, ref.carry, "sharded-grid")
    per_stream = res.steps.detected.sum(1)
    if int(res.frames_ok) != 3 * b or not bool((per_stream == 3).all()):
        raise AssertionError(f"sharded-grid: ok {int(res.frames_ok)} of {3 * b}")
    log(f"sharded-grid: B {b}, 2 x 2 positions, {GRID_CHUNKS} chunks of {chunk} a segment (N {n}, float32 "
        f"{cap.numel() * 4 / 1e9:.2f} GB), ok {int(res.frames_ok)} of {3 * b}, equal to the unsharded receive_stream; "
        f"{b * n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s; unsharded {b * n / dt_ref / 1e6:.1f}, {dt_ref:.3f} s)")


def phase_sharded_dynamic(cfg, gen) -> None:
    """"sharded-dynamic": header-declared lengths from DYNAMIC_LOCK_LENS,
    chunk 11,776 (one shortest frame), segments of 5 chunks:
    sharded_receive_long_capture_dynamic on one stream as two super-steps of
    4 positions joined by resume (a frame across every inner boundary),
    then sharded_receive_capture_grid_dynamic on 2,048 streams over 2 x 2
    positions (a frame across the time boundary): payloads and declared
    lengths equal to one unsharded receive_stream_dynamic call (uncounted)."""
    t_max = tframe.frame_num_samples(cfg, PAYLOAD)
    t_of = lambda length: int(tframe.dynamic_frame_samples(cfg, length))  # noqa: E731
    chunk = t_of(min(DYNAMIC_LOCK_LENS)) // 128 * 128
    seg = DYN_SEG_CHUNKS * chunk
    half = MESH_POSITIONS * seg
    n = 2 * half
    bounds = list(range(seg, n, seg))
    lens = [min(DYNAMIC_LOCK_LENS)] + [DYNAMIC_LOCK_LENS[i % len(DYNAMIC_LOCK_LENS)] for i in range(len(bounds))]
    starts = torch.cat([torch.full((1, 1), 500, device=DEV), boundary_starts(gen, 1, bounds, lens[1:], t_of)], 1)
    cap = placed_capture(cfg, gen, starts, lens, n)
    cap = cap[0]
    with uncounted():
        ref, dt_ref = timed(lambda: receive_stream_dynamic(cfg, cap, chunk, PAYLOAD, device=DEV))
    mesh = card_mesh()

    def two_steps():
        r1 = parallel.sharded_receive_long_capture_dynamic(cfg, mesh, cap[:half], chunk, PAYLOAD)
        return r1, parallel.sharded_receive_long_capture_dynamic(cfg, mesh, cap[half:], chunk, PAYLOAD, resume=r1.resume)

    (r1, r2), dt = timed(two_steps)
    joined = join_steps(r1, r2)
    same_detections(joined, ref.steps, "sharded-dynamic long", dynamic=True)
    same_counts(r2, ref.carry, "sharded-dynamic long")
    got_lens = joined.frame.payload_len[joined.detected].tolist()
    if int(r2.frames_ok) != len(lens) or got_lens != lens:
        raise AssertionError(f"sharded-dynamic long: ok {int(r2.frames_ok)}, lengths {got_lens}, sent {lens}")
    log(f"sharded-dynamic long: one stream, two super-steps of {MESH_POSITIONS} x {DYN_SEG_CHUNKS} chunks of {chunk}, "
        f"lengths {lens} (one across each of {len(bounds)} boundaries), ok {int(r2.frames_ok)}, equal to the unsharded "
        f"receive_stream_dynamic; {n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s; unsharded {n / dt_ref / 1e6:.1f}, "
        f"{dt_ref:.3f} s)")

    b, n = DYN_GRID_B, 2 * seg
    grid_lens = [min(DYNAMIC_LOCK_LENS), max(DYNAMIC_LOCK_LENS)]
    starts = torch.cat([
        torch.randint(500, 5000, (b, 1), generator=gen, device=DEV),
        boundary_starts(gen, b, [seg], grid_lens[1:], t_of),
    ], 1)
    cap = placed_capture(cfg, gen, starts, grid_lens, n)
    with uncounted():
        ref, dt_ref = timed(lambda: receive_stream_dynamic(cfg, cap, chunk, PAYLOAD, device=DEV))
    res, dt = timed(lambda: parallel.sharded_receive_capture_grid_dynamic(cfg, card_mesh(2, 2), cap, chunk, PAYLOAD))
    same_detections(res.steps, ref.steps, "sharded-dynamic grid", dynamic=True)
    same_counts(res, ref.carry, "sharded-dynamic grid")
    if int(res.frames_ok) != 2 * b or not torch.equal(res.resume.last_frame_end, ref.carry.last_frame_end):
        raise AssertionError(f"sharded-dynamic grid: ok {int(res.frames_ok)} of {2 * b}, resume cursor equal "
                             f"{torch.equal(res.resume.last_frame_end, ref.carry.last_frame_end)}")
    log(f"sharded-dynamic grid: B {b}, 2 x 2 positions, N {n}, lengths {grid_lens}, ok {int(res.frames_ok)} of {2 * b}, "
        f"equal to the unsharded receive_stream_dynamic; {b * n / dt / 1e6:.1f} Msamples/s ({dt:.3f} s; unsharded "
        f"{b * n / dt_ref / 1e6:.1f}, {dt_ref:.3f} s)")


def phase_cli(cfg, gen) -> None:
    """"cli": anet_torch.cli.main in-process in a temporary directory, on the
    card: modem-tx of 1 kB to a WAV, modem-rx back; the WAV's frame twice
    after gaps as a raw float32 capture cut in two, the halves through
    modem-stream-rx --lock, the first with --save-state, the second with
    --resume; sweep --snr-points 2 --frames 64; models. Every exit code 0,
    every payload byte back, sweep's two JSON lines."""
    import io
    import tempfile
    import wave

    from anet_torch import cli

    def run(*argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(list(argv))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli {argv[0]}: exit code {rc}; output {out.getvalue()!r}")
        log(f"cli {argv[0]}: {dt:.3f} s; " + " | ".join(out.getvalue().splitlines()[:3]))
        return out.getvalue()

    payload = bytes(torch.randint(0, 256, (CLI_PAYLOAD,), generator=gen, device=DEV, dtype=torch.uint8).tolist())
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return f"{tmp}/{name}"

        with open(path("msg.bin"), "wb") as fh:
            fh.write(payload)
        run("modem-tx", path("msg.bin"), "--out", path("cap.wav"))
        line = run("modem-rx", path("cap.wav"), "--len", str(CLI_PAYLOAD), "--out", path("back.bin"))
        with open(path("back.bin"), "rb") as fh:
            if fh.read() != payload:
                raise AssertionError("cli modem-rx: the bytes back differ from the bytes in")
        with plain_filterbank():
            line_plain = run("modem-rx", path("cap.wav"), "--len", str(CLI_PAYLOAD), "--out", path("plain.bin"))
        with open(path("plain.bin"), "rb") as fh:
            if fh.read() != payload or verdict_words(line) != verdict_words(line_plain):
                raise AssertionError(f"cli modem-rx: {line!r} differs from the plain filterbank's {line_plain!r}")
        with wave.open(path("cap.wav")) as w:
            frame = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0
        z = np.zeros
        x = np.concatenate([z(3000), frame, z(5000), frame, z(4000)]).astype(np.float32)
        cut = len(x) // 2 + 333
        x[:cut].tofile(path("a.f32"))
        x[cut:].tofile(path("b.f32"))
        common = ("--len", str(CLI_PAYLOAD), "--lock")
        run("modem-stream-rx", path("a.f32"), *common, "--save-state", path("st.npz"), "--out", path("s1.bin"))
        run("modem-stream-rx", path("b.f32"), *common, "--resume", path("st.npz"), "--out", path("s2.bin"))
        with open(path("s1.bin"), "rb") as f1, open(path("s2.bin"), "rb") as f2:
            if (f1.read(), f2.read()) != (payload, payload):
                raise AssertionError("cli modem-stream-rx: the bytes back over the two halves differ")
        points = [json.loads(line) for line in run("sweep", "--snr-points", "2", "--frames", "64").splitlines()]
        if len(points) != 2 or any({"snr_db", "ber", "fer", "bits"} - set(p) for p in points):
            raise AssertionError(f"cli sweep: {points}")
        log(f"cli sweep: {points}")
        if "mfsk16-fast" not in run("models"):
            raise AssertionError("cli models: mfsk16-fast not listed")



EXAMPLE_FILE_BYTES = 16384  # 64 wire frames of 264 bytes, about 50 s on the air
EXAMPLE_ADAPTIVE_BYTES = (600, 16384)
EXAMPLE_SNR_DB = 9.0  # the adaptive demo's default channel
EXAMPLE_OPUS_SECONDS = 10.0
EXAMPLE_OPUS_SNR_DB = 14.0  # the Opus demo's default channel


def run_demo(label: str, main, argv) -> tuple[str, float]:
    """(stdout, wall seconds) of a demo's main(argv) in-process on the
    card; its exit code must be 0."""
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc}; output {out.getvalue()!r}")
    return out.getvalue(), dt


def log_demo(label: str, n_samples: int, rate_hz: int, dt: float) -> None:
    """The demo's wall time, Msamples/s and real-time factor (seconds on the
    air over wall seconds)."""
    air = n_samples / rate_hz
    log(f"{label}: {n_samples} samples ({air:.3f} s on the air) in {dt:.3f} s: "
        f"{n_samples / dt / 1e6:.6f} Msamples/s, real-time factor {air / dt:.3f}")


def phase_example_file(cfg, gen) -> None:
    """"example-file": python -m anet_torch.examples.file_over_sound on a
    16 KiB seeded file (its main in-process, --device cuda): 64 wire frames
    of 264 bytes on mfsk16-fast, one capture of about 2.4 M samples with no
    batch axis, the stream's default call (float32, always searching, chunk
    1,024). Limit: every frame ok and the file back byte for byte."""
    import tempfile

    from anet_torch.examples import file_over_sound, wire_frames

    data = np.random.default_rng(SEED).integers(0, 256, EXAMPLE_FILE_BYTES, dtype=np.uint8).tobytes()
    padded = wire_frames(file_over_sound.file_chunks(data))
    if tuple(padded.shape) != (EXAMPLE_FILE_BYTES // 256, 264):
        raise AssertionError(f"example-file: wire frames {tuple(padded.shape)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "file.bin")
        with open(path, "wb") as fh:
            fh.write(data)
        text, dt = run_demo("example-file", file_over_sound.main, [path, "--device", "cuda"])
    lines = text.splitlines()
    n = padded.shape[0]
    if lines[2:] != [f"receiver: {n} frames detected, {n} ok, 0 decode errors",
                     "file reassembled byte-identical: True"]:
        raise AssertionError(f"example-file: {lines}")
    n_samples = int(re.search(r"-> (\d+) samples", lines[0]).group(1))
    log(f"example-file: {lines}")
    log_demo("example-file", n_samples, cfg.sample_rate_hz, dt)


def phase_example_adaptive(cfg, gen) -> None:
    """"example-adaptive": python -m anet_torch.examples.adaptive_modem
    --snr 9 --bytes 600, then --bytes 16384 (its main in-process, --device
    cuda): the one-shot probe on fsk2-robust, then the stream on the preset
    suggest_model picks. Limit: ofdm-coded picked, every frame ok, the
    transfer byte for byte."""
    from anet_torch.examples import adaptive_modem

    chosen = get_model("ofdm-coded").config
    for n_bytes in EXAMPLE_ADAPTIVE_BYTES:
        label = f"example-adaptive --bytes {n_bytes}"
        text, dt = run_demo(label, adaptive_modem.main,
                            ["--snr", str(EXAMPLE_SNR_DB), "--bytes", str(n_bytes), "--device", "cuda"])
        lines = text.splitlines()
        n_frames = -(-n_bytes // adaptive_modem.PER)
        if (not lines[2].startswith("adapt: ofdm-coded ")
                or not lines[3].startswith(f"transfer: {n_frames}/{n_frames} frames ok")
                or lines[4] != "adaptive transfer: OK (byte-identical)"):
            raise AssertionError(f"{label}: {lines}")
        log(f"{label}: {lines}")
        n_samples = adaptive_modem.build_capture(chosen, adaptive_modem.bulk_payload(n_bytes, 0), DEV).shape[0]
        log_demo(label, n_samples, chosen.sample_rate_hz, dt)


def opus_stand_ins(seconds: float, seed: int) -> list[bytes]:
    """Seeded byte strings of the sizes of the Opus frames the demo sends:
    20 ms frames at the encoder's default bit rate."""
    from anet_torch import constants
    from anet_torch.examples import opus_over_sound

    size = round(constants.DEFAULT_OPUS_BITRATE_BPS * opus_over_sound.FRAME_MS / 8000)
    rng = np.random.default_rng(seed)
    n = round(seconds * 1000 / opus_over_sound.FRAME_MS)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(n)]


def phase_example_opus(cfg, gen) -> None:
    """"example-opus": the legs of anet_torch.examples.opus_over_sound on
    10 s of its melody: with libopus the Opus frames, else (the card's
    machine) seeded stand-ins of their size, "opus": false; the wire
    frames, ofdm-coded TX, the two-echo channel at 14 dB, the stream's
    default call and the parse, on the card. Limit: every frame back byte
    for byte (with libopus also decoded, rms above 1,000); one step a
    chunk."""
    from anet_torch.codec import opus_available
    from anet_torch.examples import CHUNK, opus_over_sound, unwrap, wire_frames

    opus = opus_available()
    if opus:
        frames, _ = opus_over_sound.encode(opus_over_sound.melody(EXAMPLE_OPUS_SECONDS))
    else:
        frames = opus_stand_ins(EXAMPLE_OPUS_SECONDS, SEED)
    padded = wire_frames(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    capture = opus_over_sound.build_capture(cfg, padded, DEV)
    dirty = opus_over_sound.pass_channel(capture, EXAMPLE_OPUS_SNR_DB,
                                         torch.Generator(device=DEV).manual_seed(opus_over_sound.SEED))
    res = opus_over_sound.receive(cfg, dirty, padded.shape[1])
    back = unwrap(res)
    pcm = opus_over_sound.decode(back) if opus else b""
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_samples = capture.shape[0]
    if res.steps.detected.shape != (n_samples // CHUNK,) or back != frames:
        raise AssertionError(f"example-opus: {len(back)} of {len(frames)} frames back, "
                             f"{int(res.carry.decode_errors)} decode errors")
    if opus:
        x = np.frombuffer(pcm, np.int16).astype(np.float64)
        if not float(np.sqrt(np.mean(x**2))) > 1000:
            raise AssertionError("example-opus: the decoded audio is silent")
    log(f"example-opus: {json.dumps({'opus': opus, 'frames': len(frames), 'frame_len': padded.shape[1]})}")
    log_demo("example-opus", n_samples, cfg.sample_rate_hz, dt)


LAN_UDP_PORT = 48877  # the lan phase's discovery port on 127.0.0.1 (TCP: port 0)
LAN_SECONDS = 10.0
LAN_RATE = 48_000
DISCOVERY_PINGS = 200


def lan_tone() -> np.ndarray:
    """LAN_SECONDS of a 440 Hz tone at 0.3 of full scale, 48 kHz stereo int16."""
    t = np.arange(int(LAN_SECONDS * LAN_RATE))
    pcm = (0.3 * 32767 * np.sin(2 * np.pi * 440 * t / LAN_RATE)).astype(np.int16)
    return np.repeat(pcm, 2).reshape(-1, 2)


def lan_wait(done, seconds: float = 10.0) -> None:
    deadline = time.monotonic() + seconds
    while not done() and time.monotonic() < deadline:
        time.sleep(0.005)


def lan_opus_session(tone: np.ndarray) -> tuple[int, float]:
    """(frames, seconds) of the tone's WAV sent by the CLI's tx to an
    AnetReceiver with a BufferSink; every frame received and played."""
    import io
    import re
    import tempfile
    import wave

    from anet_torch import cli
    from anet_torch.config import ReceiverConfig
    from anet_torch.rx.playback import BufferSink
    from anet_torch.rx.receiver import AnetReceiver

    with tempfile.TemporaryDirectory() as tmp:
        wav = f"{tmp}/tone.wav"
        with wave.open(wav, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(LAN_RATE)
            w.writeframes(tone.astype("<i2").tobytes())
        cfg = ReceiverConfig(device_name="chip-smoke-rx", tcp_audio_port=0, udp_discovery_port=LAN_UDP_PORT + 1)
        with AnetReceiver(BufferSink(buffered_seconds=0.05), cfg) as rx:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["tx", wav, "127.0.0.1", "--port", str(rx.network.server.bound_port), "--unpaced"])
            sent = re.search(r"sent=(\d+) underflows=\d+ decode_errors=(\d+)", out.getvalue())
            if rc != 0 or sent is None:
                raise AssertionError(f"lan: cli tx exit code {rc}; output {out.getvalue()!r}")
            frames = int(sent.group(1))
            lan_wait(lambda: rx.pipeline.frames_played >= frames)
            dt = time.perf_counter() - t0
            snap = rx.metrics_snapshot()
    want = -(-int(LAN_SECONDS * 1000) // 60)  # 60 ms frames, the last one padded
    played, received = snap["gauges"]["frames_played"], snap["counters"]["frames_received"]
    if (frames, received, played) != (want, want, want) or int(sent.group(2)) or rx.pipeline.decode_errors:
        raise AssertionError(f"lan: sent {frames}, received {received}, played {played} of {want}; "
                             f"decode errors {sent.group(2)}/{rx.pipeline.decode_errors}")
    return frames, dt


def lan_raw_session(tone: np.ndarray, card) -> tuple[int, float]:
    """(frames, seconds) of the tone's PCM as raw AudioData frames at the
    negotiated cap, through AudioStreamServer after the hello; every frame
    intact and a ReceiverError back to the transmitter."""
    from anet_torch import constants
    from anet_torch.net import AudioStreamServer, RemoteAudioReceiver

    raw = tone.astype("<i2").tobytes()
    got, feedback = [], []
    with AudioStreamServer(card, frame_sink=got.append, port=0) as server:
        rx = RemoteAudioReceiver("127.0.0.1", server.bound_port, on_feedback=feedback.append).connect()
        caps = (rx.max_encoded_frame_size, rx.max_decoded_frame_size)
        if caps != (constants.MAX_ENCODED_FRAME_SIZE, constants.MAX_DECODED_FRAME_SIZE):
            raise AssertionError(f"lan: negotiated caps {caps}")
        frames = [raw[i : i + caps[0]] for i in range(0, len(raw), caps[0])]
        t0 = time.perf_counter()
        for f in frames:
            rx.send_frame(f)
        lan_wait(lambda: len(got) >= len(frames))
        dt = time.perf_counter() - t0
        lan_wait(lambda: server.send_error(True, False), 2.0)
        lan_wait(lambda: bool(feedback), 2.0)
        rx.close()
    if got != frames or server.decode_errors or not (feedback and feedback[0].audio_underflow):
        raise AssertionError(f"lan: {len(got)} of {len(frames)} frames intact {got == frames}, "
                             f"decode errors {server.decode_errors}, feedback {feedback}")
    return len(frames), dt


def phase_lan() -> dict:
    """"lan": the host edge on the card's machine; no device code."""
    import socket

    from anet_torch import constants
    from anet_torch.codec import opus_available
    from anet_torch.net import DiscoveryResponder, discover_receivers, native
    from anet_torch.proto import BroadcastMessage, DiscoveryResponse

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"lan: the native core did not build: {native.build_error()}")
    build_s = time.perf_counter() - t0
    card = DiscoveryResponse(1, 0x0200_0000_5317, "chip-smoke-rx", False, "none")
    request = BroadcastMessage(constants.MAGIC_WORD, discovery_request=True).encode()
    rtts = []
    with DiscoveryResponder(card, port=LAN_UDP_PORT, use_native=True):
        found = discover_receivers(timeout_s=0.5, port=LAN_UDP_PORT, targets=["127.0.0.1"])
        if [r.response for r in found] != [card]:
            raise AssertionError(f"lan: discovery found {found}")
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.settimeout(2.0)
            # a length prefix that narrows to -6 as an int: dropped, and the
            # responder goes on answering the pings below
            sock.sendto(bytes.fromhex("1afaffffff0f"), ("127.0.0.1", LAN_UDP_PORT))
            for _ in range(DISCOVERY_PINGS):
                t1 = time.perf_counter()
                sock.sendto(request, ("127.0.0.1", LAN_UDP_PORT))
                data, _ = sock.recvfrom(4096)
                rtts.append(time.perf_counter() - t1)
                if BroadcastMessage.decode(data).discovery_response != card:
                    raise AssertionError("lan: a discovery answer differs from the responder's card")
    tone = lan_tone()
    opus = opus_available()
    frames, dt = lan_opus_session(tone) if opus else lan_raw_session(tone, card)
    rtt_ms = np.asarray(rtts) * 1e3
    out = {
        "opus": opus, "native": True, "native_build_s": build_s,
        "discovery_rtt_ms": {"median": float(np.median(rtt_ms)), "p99": float(np.percentile(rtt_ms, 99)),
                             "n": len(rtts)},
        "audio_s": LAN_SECONDS, "frames": frames, "seconds": dt, "frames_per_s": frames / dt,
        "audio_x_realtime": LAN_SECONDS / dt,
    }
    log(f"lan: {json.dumps(out)}")
    return out


def trace_kernel_names(trace_file: str) -> list[str]:
    """The names of the kernels a torch.profiler chrome trace holds."""
    with open(trace_file) as fh:
        events = json.load(fh)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


PROBE_KERNEL = re.compile(r"(^|[\s:])probe_kernel<")  # demod_probe.cu's template, demangled


def phase_trace(cfg, gen) -> dict:
    """"trace": one warm chunk step of the locked stream under device_trace."""
    import glob
    import tempfile

    from anet_torch.obs.profiling import StageTimer, device_trace

    cap, sent, chunk, _ = locked_stream_capture(cfg, gen, "trace")
    step = functools.partial(receive_stream, cfg, chunk_size=chunk, payload_len=PAYLOAD,
                             compute_dtype=torch.bfloat16, lock=True, resident=False, device=DEV)
    carry = step(cap[:, :chunk], carry=warm_lock_carry(cfg, chunk, PAYLOAD, STREAM_B, DEV)).carry
    step(cap[:, chunk : 2 * chunk], carry=carry)  # warm: the traced step, once untraced
    torch.cuda.synchronize()
    timer = StageTimer()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp), timer.stage("stream chunk"):
            res = step(cap[:, chunk : 2 * chunk], carry=carry)
            torch.cuda.synchronize()
        files = glob.glob(f"{tmp}/*.pt.trace.json")
        if len(files) != 1:
            raise AssertionError(f"trace: device_trace wrote {files}")
        trace_bytes = os.path.getsize(files[0])
        names = trace_kernel_names(files[0])
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    kernels.reset_launch_counts()
    probe = sorted({n for n in names if PROBE_KERNEL.search(n)})
    if not launches.get("demod_probe_fused") or not probe:
        raise AssertionError(f"trace: demod_probe_fused launches {launches}; probe_kernel in the trace "
                             f"{probe}; its kernels {sorted(set(names))[:30]}")
    if not bool(res.steps.detected.all()) or not torch.equal(res.steps.frame.payload[0], sent[0]):
        raise AssertionError("trace: the traced chunk did not decode every stream's first frame")
    out = {"stages": timer.summary(), "trace_bytes": trace_bytes, "kernel_events": len(names),
           "probe_kernel": probe, "launches": launches}
    log(f"trace: {json.dumps(out)}")
    return out


# Each main path, driven with the launch counts set to 0 just before it and
# read just after: its model, the phase that drives it and the kernels it
# must launch (a bare name: any of its float routes, "<name>:f32" included;
# "<name>:int8", "<name>:f32" or "<name>:bf16": that route).


def ofdm_path_key(model: str, picked: bool = True) -> str:
    """The launch-count key of the equalizer's route on the long-frame
    paths' frames of ``model`` (OFDM_LONG_PAYLOAD bytes), as the wrapper
    picks it (in both layouts), or (``picked`` false) of the route it does
    not pick."""
    cfg = get_model(model).config
    route = kernels._ofdm_track_route(cfg.data_symbols_for_payload(OFDM_LONG_PAYLOAD), cfg.n_carriers)
    return ofdm_route_key(route if picked else {"staged": "block", "block": "staged"}[route])


PATHS = {
    "aligned": (MODEL, phase_aligned, ("decide_frame_tm",)),
    "stream": (MODEL, phase_stream, ("sync_search_fused", "demod_at_fused", "demod_probe_fused")),
    "aligned-coded": (
        CODED_MODEL,
        lambda cfg, gen: phase_aligned(cfg, gen, "aligned-coded", STREAM_B, 3),
        ("viterbi_trellis",),
    ),
    "stream-coded": (
        CODED_MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-coded"),
        ("probe_at_fused", "demod_at_energies_fused", "viterbi_trellis", "sync_search_fused"),
    ),
    "stream-coded-f32": (
        CODED_MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-coded-f32", torch.float32),
        ("demod_at_energies_fused:f32", "viterbi_trellis", "sync_search_fused"),
    ),
    "stream-dynamic": (
        MODEL,
        lambda cfg, gen: phase_stream_dynamic(cfg, gen, "stream-dynamic", DYNAMIC_LENS, False),
        ("correlate_fused", "demod_at_fused"),
    ),
    "stream-dynamic-lock": (
        MODEL,
        lambda cfg, gen: phase_stream_dynamic(cfg, gen, "stream-dynamic-lock", DYNAMIC_LOCK_LENS, True),
        ("probe_at_fused", "demod_at_fused", "sync_search_fused"),
    ),
    "stream-dynamic-coded": (
        DYNAMIC_CODED_MODEL,
        lambda cfg, gen: phase_stream_dynamic(cfg, gen, "stream-dynamic-coded", DYNAMIC_LOCK_LENS, True),
        ("probe_at_fused", "demod_at_energies_fused", "viterbi_trellis", "sync_search_fused"),
    ),
    "aligned-window": (MODEL, phase_aligned_window, ("decide_tones_tm",)),
    "oneshot": (MODEL, phase_oneshot, ("gather_rows_fused", "gather_rows_fused:int8", "tone_energies_fused:f32")),
    "aligned-ofdm": (
        OFDM_MODEL,
        lambda cfg, gen: phase_aligned_ofdm(cfg, "aligned-ofdm", STREAM_B),
        ("ofdm_track_decide_fused",),
    ),
    "aligned-ofdm-tm": (
        OFDM_MODEL,
        lambda cfg, gen: phase_aligned_ofdm(cfg, "aligned-ofdm-tm", STREAM_B, time_major=True),
        ("ofdm_track_decide_fused",),
    ),
    "aligned-ofdm-max": (
        OFDM_MAX_MODEL,
        lambda cfg, gen: phase_aligned_ofdm(cfg, "aligned-ofdm-max", ONESHOT_B, iters=3),
        ("ofdm_track_decide_fused", "viterbi_trellis"),
    ),
    "stream-ofdm": (
        OFDM_MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-ofdm"),
        ("probe_at_fused", "sync_search_fused", "ofdm_track_decide_fused"),
    ),
    "oneshot-ofdm": (OFDM_MODEL, phase_oneshot_ofdm, ("ofdm_track_decide_fused",)),
    "aligned-ofdm-long": (
        OFDM_LONG_MODEL,
        lambda cfg, gen: phase_aligned_ofdm_long(cfg, gen, "aligned-ofdm-long"),
        (ofdm_path_key(OFDM_LONG_MODEL), "viterbi_trellis"),
    ),
    "aligned-ofdm-4k": (
        OFDM_4K_MODEL,
        lambda cfg, gen: phase_aligned_ofdm_long(cfg, gen, "aligned-ofdm-4k"),
        (ofdm_path_key(OFDM_4K_MODEL),),
    ),
    "stream-dynamic-ofdm": (
        OFDM_MODEL,
        lambda cfg, gen: phase_stream_dynamic(cfg, gen, "stream-dynamic-ofdm", OFDM_DYNAMIC_LENS, True, ONESHOT_B),
        ("probe_at_fused", "sync_search_fused", "ofdm_track_decide_fused"),
    ),
    "aligned-int8": (
        MODEL,
        lambda cfg, gen: phase_aligned(cfg, gen, "aligned-int8", dtype=torch.int8),
        ("decide_frame_tm:int8",),
    ),
    "stream-int8": (
        MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-int8", torch.int8),
        ("demod_probe_fused:int8", "sync_search_fused", "demod_at_fused:int8"),
    ),
    "stream-coded-int8": (
        CODED_MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-coded-int8", torch.int8, runs=("warm-lock",)),
        ("demod_at_energies_fused:int8", "viterbi_trellis"),
    ),
    "aligned-bm": (MODEL, phase_aligned_bm, ("tone_energies_fused",)),
    "aligned-bm-decide": (
        MODEL, lambda cfg, gen: phase_aligned_bm(cfg, gen, decide=True), ("decide_tones_fused",),
    ),
    "search-blockmax": (MODEL, phase_search_blockmax, ("sync_search_blockmax",)),
    "oneshot-tracked": (MODEL, phase_oneshot_tracked, ()),  # the tracker: plain PyTorch, no kernel
    "stream-tracked": (MODEL, phase_stream_tracked, ("sync_search_fused",)),
    "stream-resident": (MODEL, phase_stream_resident, ("sync_search_fused", "demod_at_fused")),
    "stream-dynamic-int8": (
        MODEL,
        lambda cfg, gen: phase_stream_dynamic(cfg, gen, "stream-dynamic-int8", DYNAMIC_LOCK_LENS, True, int8=True),
        ("sync_search_fused", "demod_at_fused:int8"),
    ),
    "stream-ofdm-int8": (
        OFDM_MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-ofdm-int8", torch.int8),
        ("sync_search_fused", "ofdm_track_decide_fused"),
    ),
    "aligned-channel": (MODEL, phase_aligned_channel, ("decide_frame_tm",)),
    "aligned-f32": (
        MODEL, lambda cfg, gen: phase_aligned(cfg, gen, "aligned-f32", dtype=torch.float32), ("decide_frame_tm:f32",),
    ),
    "aligned-window-f32": (
        MODEL,
        lambda cfg, gen: phase_aligned_window(cfg, gen, label="aligned-window-f32", dtype=torch.float32),
        ("decide_tones_tm:f32",),
    ),
    # the presets off the align+demod kernels' and decide_frame_tm's
    # geometry: decide_tones_tm's tensor-core walk, the streams' slice and
    # the batch-major filterbank's tensor-core routes
    "aligned-audible": (
        AUDIBLE_MODEL, lambda cfg, gen: phase_aligned(cfg, gen, "aligned-audible"), ("decide_tones_tm:bf16",),
    ),
    "aligned-dense-f32": (
        DENSE_MODEL, lambda cfg, gen: phase_aligned(cfg, gen, "aligned-dense-f32", dtype=torch.float32),
        ("decide_tones_tm:f32",),
    ),
    "stream-audible-f32": (
        AUDIBLE_MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-audible-f32", torch.float32),
        ("sync_search_fused", "tone_energies_fused:f32"),
    ),
    "stream-dense": (
        DENSE_MODEL,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-dense"),
        ("sync_search_fused", "probe_at_fused", "tone_energies_fused:bf16"),
    ),
    # a custom config off every compile-time walk: the batch-major
    # filterbank's runtime-geometry walk
    "stream-custom-f32": (
        CUSTOM_STREAM_CONFIG,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-custom-f32", torch.float32),
        ("sync_search_fused", f"{FILTERBANK_ROW}:f32"),
    ),
    # the same custom modem's aligned time-major receiver: the time-major
    # pair's runtime-geometry walk
    "aligned-custom": (
        CUSTOM_STREAM_CONFIG, lambda cfg, gen: phase_aligned(cfg, gen, "aligned-custom"), (TM_ANY_ROW,),
    ),
    # a slow voice-band modem whose 15,360-sample preamble passes the
    # one-shot search stage in float32: the search's slab route
    "stream-slow-f32": (
        SLOW_STREAM_CONFIG,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-slow-f32", torch.float32, batch=SLOW_STREAM_B),
        ("sync_search_fused:f32", f"{FILTERBANK_ROW}:f32"),
    ),
    # custom modems within the reference's gate (128 % sps == 0) off the
    # align+demod kernels' compile-time walk: their runtime-geometry walk
    "stream-sps16-int8": (
        SPS16_CONFIG,
        lambda cfg, gen: phase_stream(cfg, gen, "stream-sps16-int8", torch.int8),
        ("sync_search_fused", f"{AT_ANY_ROW}:int8"),
    ),
    "stream-resident-m32": (
        M32_CONFIG, lambda cfg, gen: phase_stream_resident(cfg, gen, "stream-resident-m32"),
        ("sync_search_fused", AT_ANY_ROW),
    ),
    "sharded-demod": (MODEL, phase_sharded_demod, ("tone_energies_fused:f32",)),
    "ber-sweep": (MODEL, phase_ber_sweep, ("tone_energies_fused:f32",)),
    "sharded-long": (MODEL, phase_sharded_long, ("sync_search_fused", "demod_at_fused", "demod_probe_fused")),
    "sharded-grid": (MODEL, phase_sharded_grid, ("sync_search_fused", "demod_at_fused")),
    "sharded-dynamic": (MODEL, phase_sharded_dynamic, ("sync_search_fused", "demod_at_fused")),
    "cli": (MODEL, phase_cli, ("tone_energies_fused:f32", "sync_search_fused")),
    "example-file": (MODEL, phase_example_file, ("sync_search_fused", "demod_at_fused")),
    "example-adaptive": (
        "ofdm-coded",
        phase_example_adaptive,
        ("tone_energies_fused:f32", "sync_search_fused", "ofdm_track_decide_fused", "viterbi_trellis"),
    ),
    "example-opus": (
        "ofdm-coded", phase_example_opus, ("sync_search_fused", "ofdm_track_decide_fused", "viterbi_trellis"),
    ),
}


# Kernels a path must not launch: the reference probes an int8 or a
# float32 buffer with its plain row-aligned probe, never with
# probe_at_fused; the tracker demodulates tracked frames (no align+demod
# kernel), and the one-shot
# tracker launches nothing; the resident scan probes with the plain
# row-aligned probe and demodulates with demod_at_fused; an int8 dynamic
# carry goes to demod_at_fused's int8 instantiation only; float32 frames
# and compute on the aligned receiver take the time-major pair's float32
# route only; the presets off the align+demod kernels' geometry never reach
# them (the reference fuses only where 128 % sps == 0) or decide_frame_tm
# (OFF_THE_WALK), their aligned paths take decide_tones_tm's tensor-core
# walk on their own dtype's route, never the time-major pair's generic
# body, their streams never the time-major pair, and their streams'
# filterbank takes its compile-time walk, never filterbank_any.cu; a custom
# config's stream takes filterbank_any.cu's float32 route only (the
# CUDA-core body it replaces, filterbank_cuda_core, is gone with its key),
# and sps 480's float32 stream the search's float32 route only; a custom
# config's aligned receiver takes frame_tm_any.cu's bfloat16 route only,
# never decide_frame_tm's walk (frame_tm_generic.cu, the CUDA-core body it
# replaces, is gone with its key); an OFDM frame past shared memory never
# takes the equalizer's staged route.
OFF_THE_WALK = ("demod_at_fused", "demod_at_energies_fused", "demod_probe_fused", "decide_frame_tm")
ABSENT = {
    "aligned-f32": ("decide_frame_tm:bf16", "decide_frame_tm:int8", "decide_tones_tm"),
    "aligned-window-f32": ("decide_tones_tm:bf16", "decide_frame_tm"),
    "stream-coded-f32": ("probe_at_fused",),
    "stream-coded-int8": ("probe_at_fused",),
    "stream-dynamic-int8": ("probe_at_fused", "demod_at_fused"),
    "stream-ofdm-int8": ("probe_at_fused",),
    "oneshot-tracked": tuple(kernels.launch_counts),
    "stream-tracked": ("demod_at_fused", "demod_probe_fused"),
    "stream-resident": ("probe_at_fused", "demod_probe_fused"),
    "aligned-audible": (*OFF_THE_WALK, "tone_energies_fused", "decide_tones_fused", TM_ANY_ROW,
                        "decide_tones_tm:f32"),
    "aligned-dense-f32": (*OFF_THE_WALK, "tone_energies_fused", "decide_tones_fused", TM_ANY_ROW,
                          "decide_tones_tm:bf16"),
    "stream-audible-f32": (*OFF_THE_WALK, "decide_tones_tm", "probe_at_fused", TM_ANY_ROW, FILTERBANK_ROW,
                           "tone_energies_fused:bf16"),
    "stream-dense": (*OFF_THE_WALK, "decide_tones_tm", TM_ANY_ROW, FILTERBANK_ROW, "tone_energies_fused:f32"),
    "stream-custom-f32": (*OFF_THE_WALK, "decide_tones_tm", "probe_at_fused", TM_ANY_ROW, "tone_energies_fused",
                          "decide_tones_fused", f"{FILTERBANK_ROW}:bf16"),
    "aligned-custom": (*OFF_THE_WALK, "decide_frame_tm:int8", "decide_tones_tm", f"{TM_ANY_ROW}:f32",
                       f"{TM_ANY_ROW}:int8", "tone_energies_fused", "decide_tones_fused", FILTERBANK_ROW),
    "stream-slow-f32": (*OFF_THE_WALK, "decide_tones_tm", "probe_at_fused", TM_ANY_ROW, "tone_energies_fused",
                        "decide_tones_fused", f"{FILTERBANK_ROW}:bf16", "sync_search_fused:bf16"),
    "stream-sps16-int8": (*OFF_THE_WALK, "demod_at_fused:int8", "demod_probe_fused:int8", "probe_at_fused",
                          AT_ANY_ROW, "tone_energies_fused", FILTERBANK_ROW, TM_ANY_ROW),
    "stream-resident-m32": (*OFF_THE_WALK, "probe_at_fused", f"{AT_ANY_ROW}:int8", "tone_energies_fused",
                            FILTERBANK_ROW, TM_ANY_ROW),
    "aligned-ofdm-long": (ofdm_path_key(OFDM_LONG_MODEL, picked=False),),
    "aligned-ofdm-4k": (ofdm_path_key(OFDM_4K_MODEL, picked=False),),
}
# Rows of the kernels line on no path: none since frame_tm_any runs on
# aligned-custom's path and filterbank_any on stream-custom-f32's.
OFF_PATHS = ()


def launched(counts: dict, name: str) -> int:
    """Launches of ``name`` in ``counts``: a bare kernel name counts its
    float routes (its float32 route, "<name>:f32", where it has one), a
    suffixed one that route alone ("<name>:bf16": the bare count, the
    bfloat16 route of a kernel with a float32 route of its own)."""
    if name.endswith(":bf16"):
        return counts[name.removesuffix(":bf16")]
    return counts[name] + (counts.get(f"{name}:f32", 0) if ":" not in name else 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    # float32 products in the plain versions must not round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    build_seconds = {}
    build_all(seconds=build_seconds)
    log(f"build: {time.perf_counter() - t0:.1f} s; each source's nvcc from the common start: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(build_seconds.items(), key=lambda kv: -kv[1])))
    gen = torch.Generator(device=DEV).manual_seed(SEED)

    log("kernels vs plain versions:")
    results = phase_kernels(get_model(MODEL).config, gen)
    torch.cuda.empty_cache()
    results.update(phase_kernels_coded(get_model(CODED_MODEL).config, gen))
    torch.cuda.empty_cache()
    results.update(phase_kernels_dynamic(get_model(MODEL).config, gen))
    torch.cuda.empty_cache()
    results.update(phase_kernels_ofdm(gen))
    torch.cuda.empty_cache()
    results.update(phase_kernels_ofdm_long(gen))
    torch.cuda.empty_cache()
    results.update(phase_kernels_batch_major(get_model(MODEL).config, gen))
    torch.cuda.empty_cache()
    for name, slab in phase_kernels_search_long(gen).items():
        results[name]["slab"] = slab
    torch.cuda.empty_cache()
    generic = phase_kernels_generic(gen)
    results["decide_tones_tm"]["presets"] = generic.pop("decide_tones_tm presets")
    results.update(generic)
    torch.cuda.empty_cache()
    filterbank = phase_kernels_filterbank_generic(gen)
    for name in ("tone_energies_fused", "decide_tones_fused"):
        results[name]["presets"] = filterbank.pop(name)
    results.update(filterbank)
    torch.cuda.empty_cache()
    results.update(phase_kernels_demod_at_any(gen))
    counts = dict.fromkeys(kernels.launch_counts, 0)
    for path, (model, phase, path_kernels) in PATHS.items():
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        phase(model if isinstance(model, ModemConfig) else get_model(model).config, gen)
        path_counts = dict(kernels.launch_counts)
        log(f"launches on the {path} path: {path_counts}")
        missing = [n for n in path_kernels if launched(path_counts, n) == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} path: {missing}")
        stray = [n for n in ABSENT.get(path, ()) if launched(path_counts, n)]
        if stray:
            raise AssertionError(f"kernels launched on the {path} path that must not be: {stray}")
        for name, c in path_counts.items():
            counts[name] += c
    # the host edge, outside the paths' counts
    kernels.reset_launch_counts()
    phase_lan()
    stray = {k: v for k, v in kernels.launch_counts.items() if v}
    if stray:
        raise AssertionError(f"the lan phase launched kernels: {stray}")
    torch.cuda.empty_cache()
    phase_trace(get_model(MODEL).config, gen)
    rows = []
    for name, (source, replaces) in REPLACES.items():
        r = results[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
        }
        for route in ("int8", "f32", "block"):
            key = f"{name}:{route}"
            if key in results:
                row[route] = {"launches": counts[key], **results[key]}
        if "presets" in r:  # decide_tones_tm and the batch-major filterbank at the presets off the other walks
            row["presets"] = r["presets"]
        if "slab" in r:  # the search kernels past the one-shot stage
            row["slab"] = r["slab"]
        if name in kernels.OFF_WALK_KEYS.values():  # their other shapes and epilogues
            row.update({k: v for k, v in r.items() if k not in row})
        if name not in OFF_PATHS and (launched(counts, name) == 0 or any(
                row.get(route, {}).get("launches") == 0 for route in ("int8", "block"))):
            raise AssertionError(f"{name}: launched no time on the main paths")
        rows.append(row)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
