"""Instruction rates of the tensor-core forms that can take K8's
word-packed operands (``tools/mma_forms.cu``).

K8 (``csrc/txn_closure.cu``) computes a boolean matrix product, ``prod =
(A·Bᵀ > 0)`` on 0/1 entries packed 32 to a word. Two families of
tensor-core instructions can take such words: single-bit MMA with AND and
popcount, which reads the words as they are, and int8 MMA, which needs
each bit as a 0/1 byte. This tool builds one small kernel a form (one
``nvcc`` each, all started together, with ``_build.FLAGS``), runs each
form's instruction in a loop on every SM and prints the rate it reached,
in operations a second (2·M·N·K an instruction), beside the bf16 forms
as the yardstick. A form the assembler refuses is reported as such.

Usage, from the root of a checkout, on the card::

    python -m jepsen_tpu_torch.tools.mma_forms

Prints one line, ``MMA_FORMS`` and a JSON object, and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

from jepsen_tpu_torch import _build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "mma_forms.cu")
FORMS = {1: "mma.sync m16n8k32 s8", 2: "mma.sync m16n8k256 b1 and.popc",
         3: "wgmma m64n256k32 s8 RS", 4: "wgmma m64n256k32 s8 SS",
         5: "wgmma m64n256k256 b1 and.popc SS",
         6: "wgmma m64n256k16 bf16 SS", 7: "mma.sync m16n8k16 bf16"}
TARGET_MS = 20.0


def _so(form: int) -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.FLAGS).encode())
    return os.path.join(_build.BUILD,
                        f"mma_forms{form}-{digest.hexdigest()[:16]}.so")


def build() -> dict:
    """One ``nvcc`` a form, all at once: the loaded library by form, or
    the assembler's refusal (a string)."""
    os.makedirs(_build.BUILD, exist_ok=True)
    procs = {f: subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, f"-DFORM={f}", "-o", _so(f), SRC],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f in FORMS}
    out = {}
    for f, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            out[f] = log.strip()[-600:]
            continue
        lib = ctypes.CDLL(_so(f))
        lib.jt_probe_ops.restype = ctypes.c_longlong
        lib.jt_probe_rate.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.ptxas = "; ".join(line.strip() for line in log.splitlines()
                              if "registers" in line or "spill" in line)
        out[f] = lib
    return out


def rate(lib) -> dict:
    """The form's operations a second over every SM, by CUDA events."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads = lib.jt_probe_threads()
    blocks = sms * (2 if threads > 128 else 8)
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(iters):
        err = lib.jt_probe_rate(iters, blocks, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    iters = 64
    for _ in range(3):
        run(iters)
        torch.cuda.synchronize()
        e0.record()
        run(iters)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        if ms >= TARGET_MS / 2:
            break
        iters = int(iters * TARGET_MS / max(ms, 1e-3))
    ops = lib.jt_probe_ops() * lib.jt_probe_per_iter() * iters * blocks
    return {"ms": ms, "iters": iters, "blocks": blocks,
            "tops": ops / ms / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_forms: no CUDA device available", file=sys.stderr)
        return 1
    libs = build()
    res = {}
    for f, name in FORMS.items():
        lib = libs[f]
        if isinstance(lib, str):
            res[name] = {"refused": lib}
            continue
        try:
            res[name] = dict(rate(lib), ptxas=lib.ptxas)
        except RuntimeError as e:
            res[name] = {"failed": str(e)}
        print(f"{name}: {res[name]}", flush=True)
    print("MMA_FORMS " + json.dumps(res), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
