"""K8's two tile forms (``csrc/txn_closure.cu``) side by side: one
squaring at each width in :data:`SHAPES`, in the small tile (64 × 64,
form 0) and the big one (128 × 256, form 1), each held bit for bit
against the plain step, timed by CUDA events around ``n`` launches of
the C entry point (no Python wrapper) and by the device's own kernel
records (``keyed_times.device_ms``), in the order small, big, big,
small. ``cycles.square_form`` picks the big tile from the width where it
is the faster.

Usage, from the root of a checkout, on the card::

    python -m jepsen_tpu_torch.tools.txn_tiles

Prints one line, ``TXN_TILES`` and a JSON object of ms by shape and
form, and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from jepsen_tpu_torch.tools.keyed_times import device_ms

SHAPES = ((3, 32), (1, 96), (3, 256), (3, 512), (3, 1_024), (4, 1_024),
          (4, 2_048), (4, 4_096))


def _event_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("txn_tiles: no CUDA device available", file=sys.stderr)
        return 1
    from jepsen_tpu_torch.txn import cycles

    lib = cycles._lib()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for K, Np in SHAPES:
        rng = np.random.default_rng(K * Np)
        masks = torch.from_numpy(rng.random((K, Np, Np)) < 2 / Np).cuda()
        Cw, CwT = cycles.pack_lanes(masks)
        want = cycles.square_step_plain(Cw, CwT)
        o1, o2 = torch.empty_like(Cw), torch.empty_like(CwT)
        row = {}
        for form in (0, 1, 1, 0):
            def launch(form=form):
                err = lib.jt_txn_square_step(
                    Cw.data_ptr(), CwT.data_ptr(), o1.data_ptr(),
                    o2.data_ptr(), K, Np, form, stream)
                if err:
                    raise RuntimeError(f"K8 launch failed: CUDA error {err}")

            ev = _event_ms(launch, 300 if Np <= 2_048 else 30)
            if not (torch.equal(o1, want[0]) and torch.equal(o2, want[1])):
                raise AssertionError(f"K8 form {form} at K={K} Np={Np}: "
                                     f"differs from its plain version")
            dev = device_ms(launch, 30)
            row.setdefault(f"form{form}", []).append(
                {"event_ms": ev, "device_ms": dev and dev["total"]})
        out[f"K={K} Np={Np}"] = row
        print(f"K={K} Np={Np} (square_form {cycles.square_form(Np)}): "
              f"{json.dumps(row)}", flush=True)
    print("TXN_TILES " + json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
