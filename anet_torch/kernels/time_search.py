"""Times the acquisition search's two kernels of one or more checkouts on
one card, in turns.

    python -m anet_torch.kernels.time_search [--model NAME] [CHECKOUT ...]

Each CHECKOUT (default: this one) is a directory that holds an
``anet_torch`` package, for example a ``git archive`` of another commit
unpacked under ``build/``. Each is timed in a process of its own, in the
order given: name parent, change, change, parent to compare two within one
call. A process builds that checkout's two search sources, then times its
``sync_search_fused`` and ``sync_search_blockmax`` at the locked stream
path's geometry of the model (default mfsk16-fast: B = 8,192 streams of
noise, out_len the frame at payload 256 rounded down to 128 samples, 36,352,
and the 2,048-sample preamble; mfsk4-coded: 70,144 and 1,024; ofdm-fast:
4,736 and 640) for each (segment, template) dtype pair, CUDA events, median
of 5 after a warm-up, and prints one JSON line: the checkout, the model,
the card's ``nvidia-smi`` name and power limit, and the times in ms. The
inputs come from one seed, so every checkout times the same data. Needs a
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_CHILD = r"""
import json, sys
import numpy as np
import torch

sys.path.insert(0, {root!r})
from anet_torch import kernels
from anet_torch.dsp import family
from anet_torch.kernels.build import build_all
from anet_torch.models import get_model

build_all(("sync_search", "search_blockmax"))
cfg = get_model({model!r}).config
b, chunk = 8192, family.frame_samples(cfg, 256) // 128 * 128
tpl = family.preamble_template(cfg, "cuda").float()
k = tpl.shape[-1]
gen = torch.Generator(device="cuda").manual_seed(0)
buf = torch.randn(b, chunk + k + 127, generator=gen, device="cuda")


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times))


out = {{}}
for seg_dtype, tpl_dtype in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                             (torch.float32, torch.float32)):
    seg = buf.to(seg_dtype)[:, 1 : 1 + chunk + k - 1]  # a strided view from sample 1
    t = tpl.to(tpl_dtype)
    te = float((t.float() ** 2).sum())
    pair = f"{{str(seg_dtype)[6:]}}/{{str(tpl_dtype)[6:]}}"
    out["sync_search_fused " + pair] = time_ms(lambda: kernels.sync_search_fused(seg, t, chunk, te))
    out["sync_search_blockmax " + pair] = time_ms(lambda: kernels.sync_search_blockmax(seg, t, chunk, te))
    del seg
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def time_checkout(root: Path, model: str) -> dict:
    """The timings of the checkout at ``root``, from a process of its own."""
    run = subprocess.run(
        [sys.executable, "-c", _CHILD.format(root=str(root), model=model)], cwd=root,
        capture_output=True, text=True,
    )
    if run.returncode != 0:
        raise RuntimeError(f"{root}: exit {run.returncode}\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    model = "mfsk16-fast"
    if argv[:1] == ["--model"]:
        model, argv = argv[1], argv[2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for root in argv or [str(Path(__file__).resolve().parents[2])]:
        row = {"checkout": root, "model": model, "card": smi,
               "ms": time_checkout(Path(root).resolve(), model)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
