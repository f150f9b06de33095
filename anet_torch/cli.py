"""The command-line interface of ``anet.cli`` on the port (PyTorch, CUDA kernels).

    python -m anet_torch.cli discover                      find receivers on the LAN
    python -m anet_torch.cli tx FILE [HOST...]             stream a WAV to receivers (discover if none given)
    python -m anet_torch.cli rx [--name N] [--out out.wav] run a receiver (discovery + audio + playback)
    python -m anet_torch.cli modem-tx FILE --out cap.wav   modulate a file's bytes into a capture
    python -m anet_torch.cli modem-rx CAP --len N          demodulate a capture back to bytes
    python -m anet_torch.cli modem-stream-rx CAP --len N   demodulate every frame in a long capture
    python -m anet_torch.cli sweep [--model M]             BER/FER sweep over an SNR grid (JSON out)
    python -m anet_torch.cli models                        list modem model presets

The flags, output lines, output files and exit codes are the reference's
(0 on success, 2 when no frame decodes, 1 on a missing file, a refused
input, no receiver found or a connection error). The modem commands run
device code and take ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions). The network commands (``discover``, ``tx``,
``rx``) run no device code and take no ``--device``: they drive the host
edge (``anet_torch.net``, ``anet_torch.tx``, ``anet_torch.rx``). The reference's ``bench`` runs its own benchmark and
has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_discover(args) -> int:
    from anet_torch.net import discover_receivers

    found = discover_receivers(timeout_s=args.timeout)
    for r in found:
        d = r.response
        print(
            f"{r.address:15s}  {d.device_name:24s} mac={d.mac_address:012x} "
            f"v{d.protocol_version} streaming={d.currently_streaming} [{d.opus_version}]"
        )
    if not found:
        print("no receivers found", file=sys.stderr)
        return 1
    return 0


def _cmd_tx(args) -> int:
    import numpy as np

    from anet_torch.codec import AudioFormat
    from anet_torch.net import discover_receivers
    from anet_torch.tx import MulticastAudioOutput, normalize_for_opus, pcm_bytes, read_audio

    hosts = args.hosts
    if not hosts:
        found = discover_receivers(timeout_s=args.timeout)
        if not found:
            print("no receivers found", file=sys.stderr)
            return 1
        hosts = [r.address for r in found]
        print(f"discovered {len(hosts)} receiver(s): {', '.join(hosts)}")

    samples, fmt = read_audio(args.file)
    samples, fmt = normalize_for_opus(samples, fmt)
    out = MulticastAudioOutput(fmt, paced=not args.unpaced)
    for host in hosts:
        out.add_receiver(host, args.port)
        print(f"connected to {host}: frame={out.encoder.frame_duration_ms} ms, "
              f"max_encoded={out.encoder.max_encoded_frame_size} B")
    stream = out.as_output_stream()
    chunk_frames = fmt.sample_rate_hz // 10  # 100 ms chunks
    for start in range(0, len(samples), chunk_frames):
        stream.write(pcm_bytes(samples[start : start + chunk_frames]))
    stream.close()
    for r in out.receivers:
        s = out.stats(r)
        print(f"{r.host}: sent={s.frames_sent} underflows={s.underflows_reported} "
              f"decode_errors={s.decode_errors_reported}")
    out.close()
    return 0


def _cmd_rx(args) -> int:
    from anet_torch.config import ConfigMode, ReceiverConfig, await_and_load
    from anet_torch.obs.status import StatusIndicator, SystemState
    from anet_torch.rx.playback import BufferSink, PacedSink, WavSink
    from anet_torch.rx.receiver import AnetReceiver

    if args.config:
        config = await_and_load(args.config, timeout_s=args.config_timeout)
    else:
        config = ReceiverConfig(device_name=args.name)
    raw_sink = WavSink(args.out) if args.out else BufferSink()
    # real-time DAC drain model, matching the device's I2S pacing
    sink = PacedSink(raw_sink)
    receiver = AnetReceiver(sink, config).start()

    # SIGHUP = the config button (config.cpp:16-45): blue-blink CONFIG
    # state while the config file is re-awaited + re-applied. Without
    # --config there is nothing to reload; the press is acknowledged and
    # the bit drops immediately.
    def _apply_config() -> None:
        if args.config:
            receiver.apply_config(
                await_and_load(args.config, timeout_s=args.config_timeout)
            )
        else:
            print("config mode: no --config file to reload", file=sys.stderr)

    config_mode = ConfigMode(_apply_config)
    config_mode.install_signal_handler()

    def state() -> SystemState:
        st = receiver.status()
        if st["panicked"]:
            return SystemState.PANIC
        if config_mode.active:
            return SystemState.CONFIG
        if st["modules"]["network"]["streaming"]:
            return SystemState.STREAMING
        return SystemState.CONNECTED

    indicator = StatusIndicator(
        state, on_change=lambda s, p: print(f"[{s.value}] {p}")
    ).start()
    print(
        f"receiver '{config.device_name}' up: "
        f"udp:{config.udp_discovery_port} tcp:{receiver.network.server.bound_port}"
    )
    try:
        while True:
            time.sleep(args.status_interval)
            # one coherent observability line: counters + gauges + modules
            # (the network_get_state surface, network.cpp:590-605)
            print(json.dumps(receiver.metrics_snapshot()))
    except KeyboardInterrupt:
        pass
    finally:
        indicator.stop()
        receiver.stop()
        if args.out:
            raw_sink.close()
            print(f"wrote {args.out}")
    return 0


def _np(t):
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()


def _is_ofdm(cfg) -> bool:
    from anet_torch.dsp.family import is_ofdm

    return is_ofdm(cfg)


_AUDIO_EXTS = (".wav", ".aif", ".aiff", ".aifc", ".au", ".snd")


def _load_capture(path: str, expected_rate=None):
    """Read a capture file (WAV, AIFF or AU, or raw .f32 floats) as float32
    mono.

    ``expected_rate=None`` skips the rate check (model auto-detection loads
    the capture before a model is chosen)."""
    import numpy as np

    if path.endswith(_AUDIO_EXTS):
        from anet_torch.tx.audio import read_audio

        samples, fmt = read_audio(path)
        capture = samples.mean(axis=1).astype(np.float32) / 32768.0
        if expected_rate is not None and fmt.sample_rate_hz != expected_rate:
            print(
                f"warning: capture rate {fmt.sample_rate_hz} != modem rate "
                f"{expected_rate}; pick a matching --model",
                file=sys.stderr,
            )
        return capture
    return np.fromfile(path, dtype=np.float32)


def _wav_rate(path):
    """The audio file's sample rate, or None for raw captures."""
    if not path.endswith(_AUDIO_EXTS):
        return None
    from anet_torch.tx.audio import read_audio

    return read_audio(path)[1].sample_rate_hz


def _config(args):
    """The model's config, with the --fec override where the command has one."""
    from anet_torch.models import get_model

    cfg = get_model(args.model).config
    if getattr(args, "fec", None) is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, fec=args.fec)
    return cfg


def _cmd_modem_tx(args) -> int:
    import numpy as np

    from anet_torch.dsp.family import transmit_fn

    cfg = _config(args)
    with open(args.file, "rb") as fh:
        payload = fh.read()
    if len(payload) > 4096:
        print("payload capped at 4096 bytes (wire frame cap)", file=sys.stderr)
        return 1
    wave = _np(transmit_fn(cfg, args.device)(np.frombuffer(bytearray(payload), np.uint8)))
    if args.out.endswith(".wav"):
        import wave as wavmod

        pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2")
        with wavmod.open(args.out, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(cfg.sample_rate_hz)
            w.writeframes(pcm.tobytes())
    else:
        wave.astype(np.float32).tofile(args.out)
    print(
        f"{len(payload)} bytes -> {wave.shape[-1]} samples "
        f"({wave.shape[-1]/cfg.sample_rate_hz:.2f} s @ {cfg.sample_rate_hz} Hz) -> {args.out}"
    )
    return 0


def _link_line(cfg, snr_db: float) -> str:
    """One-line link-adaptation hint from a measured demod SNR."""
    from anet_torch.dsp.family import waveform_snr_db
    from anet_torch.models import net_bit_rate_bps, suggest_model

    w = float(waveform_snr_db(cfg, snr_db))
    m = suggest_model(w)
    return (
        f"link: waveform snr ~ {w:.1f} dB -> suggest {m.name} "
        f"({net_bit_rate_bps(m):.0f} bps net)"
    )


def _resolve_auto_model(args):
    """Handle --model auto: classify the capture, report, return
    (model_name, capture) — capture is reused so the file loads once."""
    from anet_torch.models import classify_capture, get_model

    capture = _load_capture(args.capture)
    ranked = classify_capture(capture, payload_len=args.len, device=args.device)
    if not ranked:
        print("auto-detect: capture shorter than every preset's preamble", file=sys.stderr)
        return None, capture
    top = ranked[0]
    note = ""
    if top.header_ok:
        note = "; header verified"
    elif top.header_ok is None and top.quality >= 0.5:
        note = "; unverified (pass --len to disambiguate coded presets)"
    print(f"auto-detect: {top.name} quality={top.quality:.3f} offset={top.offset}{note}")
    rate = _wav_rate(args.capture)
    if top.quality < 0.3:
        print("auto-detect: no preset matches convincingly", file=sys.stderr)
        if rate is not None:
            print(f"auto-detect: note the capture is {rate} Hz — presets at "
                  "other rates cannot match it", file=sys.stderr)
        return None, capture
    top_rate = get_model(top.name).config.sample_rate_hz
    if rate is not None and rate != top_rate:
        print(f"warning: capture rate {rate} != {top.name}'s rate {top_rate}; the "
              "match may be spurious", file=sys.stderr)
    return top.name, capture


def _cmd_modem_rx(args) -> int:
    import numpy as np

    from anet_torch.dsp.pipeline import receive_frame, receive_frame_tracked

    capture = None
    if args.model == "auto":
        args.model, capture = _resolve_auto_model(args)
        if args.model is None:
            return 2
    cfg = _config(args)
    if capture is None:
        capture = _load_capture(args.capture, cfg.sample_rate_hz)
    dev = args.device

    if args.len is None:
        from anet_torch.dsp.family import frame_samples
        from anet_torch.dsp.pipeline import receive_frame_dynamic

        if getattr(cfg, "fec", "none") != "none":
            print("automatic payload length needs an uncoded model "
                  "(pass --len, or --fec none)", file=sys.stderr)
            return 2
        if args.track:
            print("--track needs an explicit --len", file=sys.stderr)
            return 2
        # tail padding so a frame ending at the capture edge still has a
        # full max-length demod window
        t_max = frame_samples(cfg, args.max_len)
        capture = np.concatenate([capture, np.zeros(t_max, np.float32)])
        r = receive_frame_dynamic(cfg, capture, args.max_len, device=dev)
        f = r.frame
        plen = int(f.payload_len)
        print(
            f"sync offset={int(r.offset)} quality={float(r.quality):.3f} "
            f"| ok={bool(f.ok)} len={plen} magic={bool(f.magic_ok)} "
            f"crc={bool(f.payload_crc_ok)} snr={float(f.snr_db):.1f} dB"
        )
        if bool(f.ok):
            print(_link_line(cfg, float(f.snr_db)))
        if args.out:
            with open(args.out, "wb") as fh:
                fh.write(bytes(_np(f.payload)[:plen]))
            print(f"payload -> {args.out}")
        return 0 if bool(f.ok) else 2

    if _is_ofdm(cfg):
        from anet_torch.dsp import ofdm

        if args.track:
            print("--track applies to MFSK models only; OFDM uses the cyclic "
                  "prefix for timing tolerance", file=sys.stderr)
        r = ofdm.receive_frame(cfg, capture, args.len, device=dev)
        f = r.frame
        print(
            f"sync offset={int(r.offset)} quality={float(r.quality):.3f} "
            f"| ok={bool(f.ok)} magic={bool(f.magic_ok)} crc={bool(f.payload_crc_ok)} "
            f"snr={float(f.snr_db):.1f} dB"
        )
    else:
        if args.track:
            res = receive_frame_tracked(cfg, capture, args.len, device=dev)
            extra = (f" drift={float(res.drift_ppm):+.0f}ppm "
                     f"timing_rms={float(res.timing_error_rms):.3f}")
        else:
            res = receive_frame(cfg, capture, args.len, device=dev)
            extra = ""
        f = res.frame
        print(
            f"sync offset={int(res.sync.offset)} quality={float(res.sync.quality):.3f} "
            f"| ok={bool(f.ok)} magic={bool(f.magic_ok)} crc={bool(f.payload_crc_ok)} "
            f"snr={float(f.snr_db):.1f} dB" + extra
        )
    if bool(f.ok):
        print(_link_line(cfg, float(f.snr_db)))
    if args.out:
        with open(args.out, "wb") as fh:
            fh.write(bytes(_np(f.payload)))
        print(f"payload -> {args.out}")
    return 0 if bool(f.ok) else 2


def _cmd_modem_stream(args) -> int:
    import numpy as np
    import torch

    from anet_torch.stream import receive_stream

    capture = None
    if args.model == "auto":
        args.model, capture = _resolve_auto_model(args)
        if args.model is None:
            return 2
    cfg = _config(args)
    if capture is None:
        capture = _load_capture(args.capture, cfg.sample_rate_hz)
    chunk = args.chunk
    dev = args.device

    carry = None
    if args.resume:
        from anet_torch.stream import load_carry

        ckpt = load_carry(args.resume, device=dev)
        carry = ckpt.carry
        capture = np.concatenate([np.asarray(ckpt.pending, np.float32), capture])
        print(f"resumed stream state from {args.resume} "
              f"({int(carry.samples_seen)} samples seen, "
              f"{int(carry.frames_ok)} frames ok)")

    pending = np.zeros(0, np.float32)
    if args.save_state:
        # hold unconsumed tail samples in the checkpoint instead of padding
        # with zeros — padding would splice silence into the middle of a
        # frame that straddles this run and the next
        rem = len(capture) % chunk
        if rem:
            capture, pending = capture[:-rem], capture[-rem:]

    def _maybe_save(final_carry):
        if args.save_state:
            from anet_torch.stream import save_carry

            save_carry(args.save_state, final_carry, pending)
            print(f"stream state -> {args.save_state} ({len(pending)} pending samples)")

    if args.len is None:
        from anet_torch.dsp.family import frame_samples
        from anet_torch.dsp.frame import dynamic_frame_samples
        from anet_torch.stream import receive_stream_dynamic

        if getattr(cfg, "fec", "none") != "none":
            print("automatic payload length needs an uncoded model "
                  "(pass --len)", file=sys.stderr)
            return 2
        if args.track:
            print("--track needs an explicit --len", file=sys.stderr)
            return 2
        if args.int8:
            print("--int8 needs an explicit --len (the dynamic-length "
                  "header probe runs on the float/bf16 path)", file=sys.stderr)
            return 2
        if args.lock and args.frames_per_chunk not in (None, 1):
            print("--lock needs --frames-per-chunk 1 (a locked stream "
                  "predicts exactly one next frame)", file=sys.stderr)
            return 2
        if not args.save_state:
            # pad a full max-length window past the capture so a trailing
            # frame still completes, then round up to whole chunks (when
            # checkpointing, the next run's samples provide the tail)
            pad = frame_samples(cfg, args.max_len)
            capture = np.concatenate([capture, np.zeros(pad, np.float32)])
            capture = np.concatenate([capture, np.zeros((-len(capture)) % chunk, np.float32)])
        k_frames = args.frames_per_chunk
        t_min = int(dynamic_frame_samples(cfg, 1))
        if args.lock:
            # dynamic frame-lock: the header-declared length predicts each
            # next start; one candidate per chunk by contract, so keep
            # chunk <= the shortest expected frame
            k_frames = 1
            if chunk > t_min:
                print(
                    f"note: --lock with chunk {chunk} > min frame {t_min}: "
                    "frames shorter than a chunk can be skipped; lower "
                    "--chunk for dense short-frame streams",
                    file=sys.stderr,
                )
        elif k_frames is None:
            # Safe default from geometry: non-overlapping frames start at
            # least one min-length frame apart, so at most 1 + chunk/t_min
            # detection windows can complete within one chunk.
            k_frames = 1 + chunk // t_min
            if k_frames > 8:
                print(
                    f"note: geometry allows up to {k_frames} frames/chunk; "
                    "capping at 8 (pass --frames-per-chunk to raise)",
                    file=sys.stderr,
                )
                k_frames = 8
        res = receive_stream_dynamic(
            cfg, capture, chunk, args.max_len, carry=carry,
            max_frames_per_chunk=k_frames, lock=args.lock, device=dev,
        )
        # With --frames-per-chunk > 1 every step field gains a candidate
        # axis and emissions are quality-ordered within a chunk; flatten
        # and sort by frame start so --out concatenates in stream order.
        det = _np(res.steps.detected).reshape(-1)
        ok = _np(res.steps.frame.ok).reshape(-1)
        starts = _np(res.steps.frame_start).reshape(-1)
        lens = _np(res.steps.frame.payload_len).reshape(-1)
        payloads = _np(res.steps.frame.payload)
        payloads = payloads.reshape(-1, payloads.shape[-1])
        snrs = _np(res.steps.frame.snr_db).reshape(-1)
        out = open(args.out, "wb") if args.out else None
        idx = np.nonzero(det)[0]
        idx = idx[np.argsort(starts[idx], kind="stable")]
        for i in idx:
            print(
                f"frame @ sample {int(starts[i])}: ok={bool(ok[i])} "
                f"len={int(lens[i])} snr={float(snrs[i]):.1f} dB"
            )
            if out and ok[i]:
                out.write(bytes(payloads[i][: int(lens[i])]))
        if out:
            out.close()
            print(f"payloads -> {args.out}")
        print(
            f"total: {int(res.carry.frames_detected)} detected, "
            f"{int(res.carry.frames_ok)} ok, "
            f"{int(res.carry.decode_errors)} decode errors"
        )
        if ok.any():
            print(_link_line(cfg, float(snrs[ok].mean())))
        _maybe_save(res.carry)
        return 0 if int(res.carry.frames_ok) > 0 else 2

    if args.frames_per_chunk is not None and args.frames_per_chunk > 1:
        print(
            "warning: --frames-per-chunk applies to headers-from-stream "
            "mode only; with --len each chunk decodes a single fixed-"
            "length candidate (choose chunk <= frame length instead)",
            file=sys.stderr,
        )
    capture = np.concatenate([capture, np.zeros((-len(capture)) % chunk, np.float32)])
    track = args.track
    if track and _is_ofdm(cfg):
        print("--track applies to MFSK models only; OFDM uses the cyclic "
              "prefix for timing tolerance", file=sys.stderr)
        track = False
    if track and args.lock:
        print("--lock does not compose with --track; using --track", file=sys.stderr)
    if args.int8:
        # int8 sliding stream buffer: the capture quantizes once at the
        # append edge; decisions and quality ratios are scale-invariant
        if _is_ofdm(cfg) or getattr(cfg, "fec", "none") != "none" or track:
            print("--int8 applies to uncoded MFSK models without --track", file=sys.stderr)
            return 2
        if carry is not None:
            if carry.buffer.dtype != torch.int8:
                print("--int8 ignored: resumed checkpoint carries a "
                      f"{str(carry.buffer.dtype).removeprefix('torch.')} buffer (the "
                      "checkpoint's dtype governs)", file=sys.stderr)
        else:
            from anet_torch.stream import init_carry

            carry = init_carry(cfg, chunk, args.len, (), track=False, dtype=torch.int8, device=dev)
    res = receive_stream(
        cfg, capture, chunk, args.len, carry=carry, track=track,
        lock=args.lock and not track, device=dev,
    )
    det = _np(res.steps.detected)
    ok = _np(res.steps.frame.ok)
    starts = _np(res.steps.frame_start)
    payloads = _np(res.steps.frame.payload)
    snrs = _np(res.steps.frame.snr_db)
    out = open(args.out, "wb") if args.out else None
    for i in np.nonzero(det)[0]:
        print(f"frame @ sample {int(starts[i])}: ok={bool(ok[i])} snr={float(snrs[i]):.1f} dB")
        if out and ok[i]:
            out.write(bytes(payloads[i]))
    if out:
        out.close()
        print(f"payloads -> {args.out}")
    print(
        f"total: {int(res.carry.frames_detected)} detected, "
        f"{int(res.carry.frames_ok)} ok, {int(res.carry.decode_errors)} decode errors"
    )
    if ok.any():
        print(_link_line(cfg, float(snrs[ok].mean())))
    _maybe_save(res.carry)
    return 0 if int(res.carry.frames_ok) > 0 else 2


def _cmd_sweep(args) -> int:
    import torch

    from anet_torch.channel import ChannelConfig
    from anet_torch.parallel import ber_sweep, make_mesh

    cfg = _config(args)
    mesh = make_mesh(device=args.device)
    snrs = [args.snr_min + i * args.snr_step for i in range(args.snr_points)]
    frames = args.frames - (args.frames % mesh.devices.size) or mesh.devices.size
    # --echo E adds two room reflections (E at 3 samples, 0.4E at 5) so the
    # sweep measures frequency-selective thresholds, not just flat AWGN —
    # dense constellations lose far more margin to echo than to noise.
    taps = (1.0, 0.0, 0.0, args.echo, 0.0, 0.4 * args.echo) if args.echo else None
    pt = ber_sweep(
        cfg,
        mesh,
        torch.Generator().manual_seed(args.seed),
        snr_grid_db=snrs,
        frames_per_point=frames,
        payload_len=args.payload,
        channel=ChannelConfig(multipath_taps=taps),
    )
    ber, fer, bits = _np(pt.ber), _np(pt.fer), _np(pt.total_bits)
    for i, snr in enumerate(snrs):
        print(json.dumps({
            "model": args.model,
            "snr_db": snr,
            "ber": float(ber[i]),
            "fer": float(fer[i]),
            "bits": int(bits[i]),
        }))
    return 0


def _cmd_models(args) -> int:
    from anet_torch.models import OPERATING_SNR_DB, list_models, net_bit_rate_bps, suggest_model

    if args.snr is not None:
        m = suggest_model(args.snr, margin_db=args.margin)
        print(
            f"{m.name}  (needs >= {OPERATING_SNR_DB[m.name]:+.1f} dB SNR, "
            f"{net_bit_rate_bps(m):.0f} bps net)  {m.description}"
        )
        return 0
    for m in list_models():
        c = m.config
        if _is_ofdm(c):
            mod = {2: "QPSK", 4: "16QAM", 6: "64QAM"}[c.bits_per_carrier]
            kind = f"OFDM {c.n_carriers}x{mod}"
        else:
            kind = f"{c.num_tones:3d}-FSK @{c.symbol_rate_hz:5d} baud"
        print(f"{m.name:15s} {kind:22s} {c.bit_rate_bps:7.0f} bps  {m.description}")
    return 0


def _positive_int(v):
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return n


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m anet_torch.cli", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; cpu runs the "
                            "kernels' plain versions)")

    p = sub.add_parser("discover", help="find receivers on the LAN")
    p.add_argument("--timeout", type=float, default=2.0)
    p.set_defaults(fn=_cmd_discover)

    p = sub.add_parser("tx", help="stream a WAV file to receivers")
    p.add_argument("file")
    p.add_argument("hosts", nargs="*")
    p.add_argument("--port", type=int, default=58764)
    p.add_argument("--timeout", type=float, default=2.0)
    p.add_argument("--unpaced", action="store_true", help="no real-time pacing")
    p.set_defaults(fn=_cmd_tx)

    p = sub.add_parser("rx", help="run a receiver")
    p.add_argument("--name", default="anet-receiver")
    p.add_argument("--out", help="write received audio to this WAV file")
    p.add_argument("--config", help="JSON config file (awaited if absent)")
    p.add_argument("--config-timeout", type=float, default=None)
    p.add_argument("--status-interval", type=float, default=5.0)
    p.set_defaults(fn=_cmd_rx)

    p = sub.add_parser("modem-tx", help="modulate bytes into a modem capture")
    p.add_argument("file")
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="mfsk16-fast")
    p.add_argument("--fec", choices=["none", "conv"],
                   help="override the model's FEC setting")
    device_flag(p)
    p.set_defaults(fn=_cmd_modem_tx)

    p = sub.add_parser("modem-rx", help="demodulate a capture")
    p.add_argument("capture")
    p.add_argument("--len", type=int, default=None,
                   help="payload length in bytes (omit to read it from the "
                        "frame header, bounded by --max-len)")
    p.add_argument("--max-len", type=int, default=512,
                   help="payload length bound when --len is omitted")
    p.add_argument("--out", help="write payload bytes here")
    p.add_argument("--model", default="mfsk16-fast",
                   help="preset name, or 'auto' to classify the capture by "
                        "its preamble")
    p.add_argument("--track", action="store_true",
                   help="symbol-clock recovery (tolerates sample-rate drift)")
    p.add_argument("--fec", choices=["none", "conv"],
                   help="override the model's FEC setting")
    device_flag(p)
    p.set_defaults(fn=_cmd_modem_rx)

    p = sub.add_parser("modem-stream-rx", help="demodulate every frame in a long capture")
    p.add_argument("capture")
    p.add_argument("--len", type=int, default=None,
                   help="payload length per frame (omit to read each frame's "
                        "length from its header, bounded by --max-len)")
    p.add_argument("--max-len", type=int, default=512,
                   help="per-frame payload bound when --len is omitted")
    p.add_argument("--model", default="mfsk16-fast",
                   help="preset name, or 'auto' to classify the capture by "
                        "its preamble")
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--frames-per-chunk", type=_positive_int, default=None,
                   help="decode up to K frames per chunk (headers-from-"
                        "stream mode); default: derived from chunk/"
                        "min-frame geometry so no dense layout of short "
                        "frames can drop one (capped at 8 — raise "
                        "explicitly for extreme chunk/frame ratios)")
    p.add_argument("--out", help="concatenate recovered payloads here")
    p.add_argument("--track", action="store_true",
                   help="symbol-clock tracking per frame (MFSK; slower)")
    p.add_argument("--lock", action="store_true",
                   help="frame-lock mode: verify the predicted next frame "
                        "with a cheap probe, full search only on "
                        "acquisition (fastest for back-to-back frames; "
                        "with headers-from-stream mode the declared length "
                        "predicts each next start)")
    p.add_argument("--int8", action="store_true",
                   help="int8 sliding stream buffer (uncoded MFSK, fixed "
                        "--len): quantized ingest halves the buffer "
                        "traffic; decisions identical")
    p.add_argument("--resume", metavar="STATE.npz",
                   help="continue from a saved stream checkpoint")
    p.add_argument("--save-state", metavar="STATE.npz",
                   help="checkpoint the final stream state here")
    device_flag(p)
    p.set_defaults(fn=_cmd_modem_stream)

    p = sub.add_parser("sweep", help="BER/FER sweep (one JSON line per point)")
    p.add_argument("--model", default="mfsk16-fast")
    p.add_argument("--snr-min", type=float, default=-14.0)
    p.add_argument("--snr-step", type=float, default=2.0)
    p.add_argument("--snr-points", type=int, default=8)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--payload", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--echo", type=float, default=0.0,
                   help="room echo amplitude: two reflections at 3 and 5 "
                        "sample lags (0 = off); for longer reverb use "
                        "ChannelConfig(multipath_taps=...) directly")
    device_flag(p)
    p.set_defaults(fn=_cmd_sweep)

    p = sub.add_parser("models", help="list modem model presets")
    p.add_argument("--snr", type=float, default=None,
                   help="suggest the fastest preset for this channel SNR (dB)")
    p.add_argument("--margin", type=float, default=2.0,
                   help="link margin in dB for --snr (default 2)")
    p.set_defaults(fn=_cmd_models)
    return parser


def main(argv=None) -> int:
    from anet_torch._device import resolve_device

    args = build_parser().parse_args(argv)
    try:
        if hasattr(args, "device"):
            resolve_device(args.device)
    except RuntimeError as e:
        print(f"anet_torch: error: {e} (--device cpu)", file=sys.stderr)
        return 1
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        return 0  # stdout closed early (e.g. piped into head) — not an error
    except (FileNotFoundError, IsADirectoryError) as e:
        print(f"anet_torch: error: {e}", file=sys.stderr)
        return 1
    except (ConnectionError, TimeoutError) as e:
        print(f"anet_torch: connection error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"anet_torch: I/O error: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"anet_torch: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
