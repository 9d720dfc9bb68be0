#!/usr/bin/env python3
"""Cycles per field product and per point formula of the port's verify
kernels, per launch shape, on an NVIDIA GPU.

    python3 tools/torch_product_cycles.py

Builds tools/torch_product_cycles.cu with nvcc for sm_90a into
build/torch_tools/ and runs it: one warp runs 2000 dependent products
(fe::mul<G> for G = 32, 8, 1, and the one-thread register-level
product); then one lane alone on the card runs 200 point doublings, 200
point additions, 200 lane barriers and 200 limb-parallel steps on each
generic-kernel shape (Q, G) and on the keyed kernel's one-group formulas;
then sha512_keyed's two-block chain for one warp alone on the card.
Prints SM cycles for each, with the card's name and power limit.  Needs
nvcc and a card; exits non-zero without them.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    from cometbft_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "torch_tools")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "torch_product_cycles")
    src = os.path.join(ROOT, "tools", "torch_product_cycles.cu")
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-o", exe, src], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
