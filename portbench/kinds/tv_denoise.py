"""Total-variation denoising on the dual, a batch of noisy images a
request (FASTA's TV example, arXiv:1411.3406)."""

from __future__ import annotations

import torch

from ..reference import tv_denoise as ref


def make_inputs(cfg: dict, traffic: dict, gen: torch.Generator,
                device) -> dict:
    """Each image the sum of ``rectangles`` random rectangles (corner in
    the top-left quarter, sides from an eighth to a half of the image's,
    standard normal heights), scaled to [0, 1], plus σ·noise (the math of
    ``reference_oracle/generators.py``'s ``make_tv``, on the device), in
    float32: one call a quantity for the whole pool, and elementwise
    kernels only (no library product, whose start the program's TV route
    never pays)."""
    h, w, R, sigma = cfg["h"], cfg["w"], cfg["rectangles"], cfg["sigma"]
    P, B = traffic["pool"], traffic["batch"]
    N = P * B

    def ints(lo, hi):
        return torch.randint(lo, hi, (N, R, 1), generator=gen, device=device)

    r0, c0 = ints(0, h // 2), ints(0, w // 2)
    r1, c1 = r0 + ints(h // 8, h // 2), c0 + ints(w // 8, w // 2)
    heights = torch.randn((N, R, 1), generator=gen, device=device)
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    row_in = ((rows >= r0) & (rows < r1)).float() * heights      # (N, R, h)
    col_in = ((cols >= c0) & (cols < c1)).float()                # (N, R, w)
    img = torch.zeros((N, h, w), device=device)
    for i in range(R):
        img.addcmul_(row_in[:, i, :, None], col_in[:, i, None, :])
    lo = img.amin(dim=(1, 2), keepdim=True)
    span = torch.clamp_min(img.amax(dim=(1, 2), keepdim=True) - lo, 1e-12)
    noise = torch.randn((N, h, w), generator=gen, device=device)
    pool = (img - lo) / span + sigma * noise
    return dict(pool=pool.reshape(P, B, h, w))


def problem(cfg: dict, inputs: dict, ftt):
    pool = inputs["pool"]
    h, w = cfg["h"], cfg["w"]
    return ftt.Problem(
        name=cfg["name"], op=ftt.ScaledOp(cfg["mu"], ftt.TVDiv2D()),
        fterm=ftt.LeastSquares(pool[0, 0]), gterm=ftt.BoxIndicator(-1.0, 1.0),
        x0=torch.zeros((2, h, w), device=pool.device),
        tau0=cfg["options"]["tau0"])


def reference_inputs(inputs: dict, slots: list) -> dict:
    """b of each kept (batch, image) slot."""
    idx = torch.tensor(slots, device=inputs["pool"].device)
    return dict(b=inputs["pool"][idx[:, 0], idx[:, 1]].clone())


def reference_solve(cfg: dict, data: dict, dtype: torch.dtype):
    return ref.solve(data["b"], cfg, dtype)


def judge(cfg: dict, data: dict, kept: dict) -> dict:
    """The reference's float64 solve of the kept images and the numbers
    compared: the largest distance of a denoised pixel (the image is
    unique where the dual field is not), the largest relative gap of a
    dual objective and the largest difference of iteration counts."""
    b, mu = data["b"].double(), cfg["mu"]
    p = kept["solutions"].double()
    r = reference_solve(cfg, data, torch.float64)
    pr = r.solution.double()
    pixel = (ref.image(b, p, mu) - ref.image(b, pr, mu)).abs().amax(
        dim=(1, 2))
    fp, fr = ref.dual_objective(b, p, mu), ref.dual_objective(b, pr, mu)
    iters = (torch.as_tensor(kept["iterations"], device=r.iterations.device)
             - r.iterations).abs()
    return {"image_max_dist": float(pixel.max()),
            "dual_objective_rel_gap": float(((fp - fr).abs() / fr).max()),
            "iteration_gap": float(iters.max()),
            "reference_unconverged": float((~r.converged).sum())}
