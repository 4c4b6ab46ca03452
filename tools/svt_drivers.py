"""Singular-value thresholding on one CUDA card: its accuracy and time by
cuSOLVER driver and working precision, and the 1-bit matrix-completion
solves that it serves.

    python3 tools/svt_drivers.py

The routes: float32 through ``torch.linalg.svd``'s default driver
(Jacobi, ``gesvdj``), ``gesvd`` (QR) and ``gesvda`` (approximate), each
rebuilt in float32 with TF32 off, and the port's ``prox.svt`` (the SVD
and the rebuild in float64, rounded to float32).  The host's float32
LAPACK SVT is the first column.

* Accuracy: SVT(Z, t) of a float32 200×200 Z against LAPACK's float64 SVT
  of the same Z, max |Δ| over max |ref|, for a Gaussian Z (t = 0 and 5),
  rank 5 plus noise 1e-5 (t = 0 and 1e-4), rank 5 plus noise 0.3 (t =
  3.4, matrix completion's τμ) and singular values graded from 1 to 1e-6
  (t = 1e-3).  A route that raises prints its error.
* Time: ms a call of each card route on a Gaussian 200×200 (t = 1), 20
  calls after 3, CUDA-synchronised wall time.
* Solves: ``problems.build("matrix_completion")`` (200×200, rank 5,
  float32, τ₀ 1.7) on the host (LAPACK in float32, and the port's
  route) and on the card (each route), the route in turn the solver's
  SVT, plain, adaptive and FISTA at tol 1e-6 and 2000 iterations:
  converged, iterations, the least normalized residual.

Prints the card's name and power limit first.  Fails without a CUDA
device.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fasta_tpu_torch import problems  # noqa: E402
from fasta_tpu_torch import prox as port_prox  # noqa: E402
from fasta_tpu_torch.harness import MODE_OPTIONS  # noqa: E402

N = 200


def f32_svt(driver):
    """SVT in float32 through ``driver`` (None: the default)."""
    def svt(Z, t):
        kw = {"driver": driver} if driver and Z.is_cuda else {}
        U, s, Vh = torch.linalg.svd(Z, full_matrices=False, **kw)
        s = torch.clamp_min(s - t, 0.0)
        return torch.matmul(U * s[..., None, :].to(U.dtype), Vh)
    return svt


ROUTES = {"f32 default": f32_svt(None), "f32 gesvd": f32_svt("gesvd"),
          "f32 gesvda": f32_svt("gesvda"), "port (f64)": port_prox.svt}


def cases():
    rng = np.random.default_rng(0)
    low = rng.standard_normal((N, 5)) @ rng.standard_normal((5, N))
    q1, _ = np.linalg.qr(rng.standard_normal((N, N)))
    q2, _ = np.linalg.qr(rng.standard_normal((N, N)))
    return {
        "gaussian t=0": (rng.standard_normal((N, N)), 0.0),
        "gaussian t=5": (rng.standard_normal((N, N)), 5.0),
        "rank5+1e-5 t=0": (low + 1e-5 * rng.standard_normal((N, N)), 0.0),
        "rank5+1e-5 t=1e-4": (low + 1e-5 * rng.standard_normal((N, N)),
                              1e-4),
        "rank5+0.3 t=3.4": (low + 0.3 * rng.standard_normal((N, N)), 3.4),
        "graded 1..1e-6 t=1e-3": ((q1 * np.logspace(0, -6, N)) @ q2.T,
                                  1e-3),
    }


def accuracy() -> None:
    for what, (Z, t) in cases().items():
        Z32 = Z.astype(np.float32)
        U, s, Vh = np.linalg.svd(Z32.astype(np.float64), full_matrices=False)
        ref = (U * np.maximum(s - t, 0.0)) @ Vh
        scale = np.abs(ref).max()
        host = f32_svt(None)(torch.as_tensor(Z32), t).numpy()
        cols = [f"host f32 {np.abs(host - ref).max() / scale:.1e}"]
        for route, svt in ROUTES.items():
            try:
                got = svt(torch.as_tensor(Z32, device="cuda"), t).cpu()
                cols.append(f"{route} "
                            f"{np.abs(got.numpy() - ref).max() / scale:.1e}")
            except RuntimeError as err:
                cols.append(f"{route} raised ({str(err)[:50]})")
        print(f"SVT rel err, {what}: " + "; ".join(cols), flush=True)


def timing() -> None:
    Z = torch.randn(N, N, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    for route, svt in ROUTES.items():
        for _ in range(3):
            svt(Z, 1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            svt(Z, 1.0)
        torch.cuda.synchronize()
        print(f"SVT {N}x{N} {route}: "
              f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms a call",
              flush=True)


def solves() -> None:
    runs = ([("cpu", "f32 default"), ("cpu", "port (f64)")]
            + [("cuda", r) for r in ROUTES])
    for device, route in runs:
        port_prox.svt = ROUTES[route]
        p = problems.build("matrix_completion", device=device)
        p.tau0 = 1.7
        for mode, kw in MODE_OPTIONS.items():
            t0 = time.perf_counter()
            r = p.solve(tol=1e-6, max_iters=2000, **kw)
            print(f"matrix_completion {device} {route} {mode}: converged="
                  f"{r.converged} in {r.iteration_count} iterations "
                  f"({time.perf_counter() - t0:.1f} s), least normalized "
                  f"residual {np.min(r.norm_residuals):.2e}", flush=True)
    port_prox.svt = ROUTES["port (f64)"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("svt_drivers.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    accuracy()
    timing()
    solves()


if __name__ == "__main__":
    main()
