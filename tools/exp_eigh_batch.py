"""Where a batched ``torch.linalg.eigh`` stops running on the card.

For each matrix size the port hands to ``eigh`` (4x4 from the multi-view
DLT, 9x9 from the two-view solvers, 12x12 from PnP) and each dtype, the
largest batch of finite symmetric positive definite matrices that runs:
powers of two from 2^10 to 2^20, then a bisection between the last
batch that ran and the first that raised. After every failure a small
call checks that the device is still usable. One JSON line a (size,
dtype) on standard output, with the raising call's message.

    python tools/exp_eigh_batch.py [--sizes 4,9,12] [--dtypes float64,float32]
"""

import argparse
import json
import subprocess
import sys
import time

import torch


def _spd(B, n, dtype, device):
    g = torch.Generator(device=device).manual_seed(B * 31 + n)
    A = torch.randn(B, 2 * n, n, generator=g, dtype=torch.float64, device=device)
    return (A.transpose(-1, -2) @ A).to(dtype)


def runs(B, n, dtype, device):
    """(ran, message, seconds) of one eigh of B matrices of size n."""
    M = _spd(B, n, dtype, device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        torch.linalg.eigh(M)
        torch.cuda.synchronize(device)
        return True, "", time.perf_counter() - t0
    except RuntimeError as e:
        return False, str(e).splitlines()[0][:300], time.perf_counter() - t0


def still_usable(device) -> bool:
    try:
        torch.linalg.eigh(_spd(8, 4, torch.float64, device))
        torch.cuda.synchronize(device)
        return True
    except RuntimeError:
        return False


def probe(n, dtype, device, lo_pow=10, hi_pow=20):
    rows, last_ok, first_bad, msg = [], None, None, ""
    for p in range(lo_pow, hi_pow + 1):
        ok, m, s = runs(1 << p, n, dtype, device)
        rows.append([1 << p, ok, round(s, 6)])
        if ok:
            last_ok = 1 << p
        else:
            first_bad, msg = 1 << p, m
            break
    if first_bad is not None and last_ok is not None:
        lo, hi = last_ok, first_bad
        while hi - lo > 1:
            mid = (lo + hi) // 2
            ok, m, _ = runs(mid, n, dtype, device)
            if ok:
                lo = mid
            else:
                hi, msg = mid, m
        last_ok, first_bad = lo, hi
    return {"n": n, "dtype": str(dtype).split(".")[-1], "largest_ok": last_ok,
            "first_raising": first_bad, "message": msg, "powers": rows,
            "usable_after": still_usable(device)}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="4,9,12")
    ap.add_argument("--dtypes", default="float64,float32")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": card.stdout.strip(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    for dt in a.dtypes.split(","):
        for n in (int(s) for s in a.sizes.split(",")):
            print(json.dumps(probe(n, getattr(torch, dt), dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
