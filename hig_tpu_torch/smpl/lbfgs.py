"""L-BFGS with a zoom line search: the algorithm of ``optax.lbfgs()`` (optax
0.2.6) as ``hig_tpu/smpl/smplify.py``'s ``_lbfgs_run`` drives it, in
PyTorch.

One iteration, as optax's chain of ``scale_by_lbfgs(memory_size=10,
scale_init_precond=True)``, ``scale(-1)`` and
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")`` computes it:

1. the direction −P·g by the two-loop recursion over a ring of the last 10
   parameter and gradient differences (their weights ρ = 1/⟨Δg, Δw⟩, 0
   where that is 0), the initial preconditioner γ·I with γ = ⟨Δg, Δw⟩ /
   ‖Δg‖² of the newest pair, and at the first iteration γ = min(1, 1/‖g‖);
2. the zoom line search (Nocedal & Wright, algorithms 3.5 and 3.6, with
   optax's cubic, quadratic and bisection rules and its default
   tolerances: slope 1e-4, curvature 0.9, approximate decrease 1e-6,
   interval 1e-5, increase factor 2, no maximal step), starting from step
   size 1: at most 20 evaluations of the objective and its gradient, the
   last of which, or the safe step that ensured sufficient decrease when
   the search fails, is the iteration's step;
3. w ← w + η·d, keeping the value and gradient at the step for the next
   iteration (``optax.value_and_grad_from_state``).

The parameters are one float32 vector on their device; the gradient comes
from ``torch.autograd``. The line search's scalars are float32 on the host,
as XLA computes them in float32: each evaluation reads back its value and
its slope (one copy); the recursion stays on the device. On a CUDA device
with ``graph`` (the default) the objective and its gradient are captured
once as one CUDA graph on a static parameter buffer (after one eager
warm-up on the capture stream) and every evaluation replays it: the
eager evaluation's kernels on the same inputs, so the same numbers, without
the host's launches (an objective that copies from the host cannot be
captured, and the capture raises). ``torch.optim.LBFGS`` is another
algorithm (its strong-Wolfe search takes other steps).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

f32 = np.float32
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = f32(1e-4), f32(0.9), f32(1e-6)
INTERVAL_THRESHOLD, INCREASE_FACTOR, TOL = f32(1e-5), f32(2.0), f32(0.0)


@dataclasses.dataclass
class LBFGSInfo:
    """What a run did: the objective's evaluations (value and gradient),
    the line-search steps of each iteration, and, when recorded, each
    iterate's parameters (the starting point first)."""

    evaluations: int = 0
    linesearch_steps: list = dataclasses.field(default_factory=list)
    iterates: list = dataclasses.field(default_factory=list)


def _flatten(params: dict[str, torch.Tensor]):
    names = sorted(params)
    shapes = [params[n].shape for n in names]
    x = torch.cat([params[n].detach().reshape(-1).float() for n in names])

    def unflatten(v: torch.Tensor) -> dict[str, torch.Tensor]:
        out, lo = {}, 0
        for n, s in zip(names, shapes):
            size = int(np.prod(s)) if len(s) else 1
            out[n] = v[lo:lo + size].reshape(s)
            lo += size
        return out

    return x, unflatten


class _Objective:
    """value and gradient of ``fun`` at a flat vector, counted; with
    ``graph`` on a CUDA vector, a replay of the captured evaluation."""

    def __init__(self, fun: Callable, unflatten: Callable, info: LBFGSInfo,
                 graph: bool = True):
        self.fun, self.unflatten, self.info = fun, unflatten, info
        self.graph, self.captured = graph, None

    def eager(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            v = x.detach().requires_grad_(True)
            value = self.fun(self.unflatten(v))
            (grad,) = torch.autograd.grad(value, v)
        return value.detach().float(), grad

    def capture(self, x: torch.Tensor) -> None:
        static = x.detach().clone()
        stream = torch.cuda.Stream(x.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.eager(static)  # builds what a capture refuses to (caches, workspaces)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            value, grad = self.eager(static)
        torch.cuda.current_stream().wait_stream(stream)
        self.captured = (graph, static, value, grad)

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        self.info.evaluations += 1
        if not (self.graph and x.is_cuda):
            return self.eager(x)
        if self.captured is None:
            self.capture(x)
        graph, static, value, grad = self.captured
        static.copy_(x)
        graph.replay()
        return value.clone(), grad.clone()

    def on_line(self, x, step, d):
        """(value, grad, slope) at x + step·d; value and slope on the host."""
        value, grad = self(x + step * d)
        host = torch.stack([value, torch.dot(grad, d)]).cpu().numpy()
        return f32(host[0]), grad, f32(host[1])


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], f32)
    A, B = (d1 @ np.array([fb - fa - C * db, fc - fa - C * dc], f32)) / denom
    radical = B * B - f32(3.0) * A * C
    return f32(a + (-B + np.sqrt(radical)) / (f32(3.0) * A))


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return f32(a - fpa / (f32(2.0) * B))


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (f32(2.0) * SLOPE_RTOL - f32(1.0)) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * abs(value_init)
    # np.maximum and np.minimum carry a NaN through, as jnp's do
    err = np.maximum(np.minimum(np.maximum(approx, delta_values), err), f32(0.0))
    return f32(np.inf) if np.isnan(err) else f32(err)


def _curvature_error(slope, slope_init):
    err = np.maximum(abs(slope) - CURV_RTOL * abs(slope_init), f32(0.0))
    return f32(np.inf) if np.isnan(err) else f32(err)


def zoom_linesearch(objective: _Objective, x: torch.Tensor, d: torch.Tensor, value, grad):
    """optax's zoom line search along ``d`` from ``x`` (value ``value``,
    gradient ``grad`` there), initial step size 1. Returns (step size,
    value and gradient at the step, line-search steps taken)."""
    slope_init = f32(torch.dot(d, grad).item())
    value_init = f32(value.item())
    s = dict(count=0, stepsize=f32(0.0), value=value_init, grad=grad, slope=slope_init,
             decrease_error=f32(np.inf), interval_found=False, done=False, failed=False,
             low=f32(0.0), value_low=value_init, slope_low=slope_init, high=f32(0.0),
             value_high=value_init, slope_high=slope_init, cubic_ref=f32(0.0),
             value_cubic_ref=value_init, safe_stepsize=f32(0.0), safe_value=value_init,
             safe_grad=grad)
    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                _zoom_into_interval(s, objective, x, d, value_init, slope_init)
            else:
                _search_interval(s, objective, x, d, value_init, slope_init)
            if s["failed"] and (s["safe_stepsize"] > 0.0 or np.isinf(s["decrease_error"])):
                s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                         grad=s["safe_grad"])
    return s["stepsize"], s["value"], s["grad"], s["count"]


def _search_interval(s, objective, x, d, value_init, slope_init):
    """Algorithm 3.5: grow the step until an interval holds a good one."""
    count = s["count"]
    prev = (s["stepsize"], s["value"], s["slope"])
    new_stepsize = f32(1.0) if count == 0 else f32(INCREASE_FACTOR * prev[0])
    value, grad, slope = objective.on_line(x, float(new_stepsize), d)
    dec = _decrease_error(new_stepsize, value, slope, value_init, slope_init)
    curv = _curvature_error(slope, slope_init)
    error = max(dec, curv)
    if dec <= TOL:
        s.update(safe_stepsize=new_stepsize, safe_value=value, safe_grad=grad)
    set_high_to_new = (dec > 0.0) or (value >= prev[1] and count > 0)
    set_low_to_new = slope >= 0.0 and not set_high_to_new
    if set_low_to_new:
        low, high = (new_stepsize, value, slope), prev
    else:
        low, high = prev, (new_stepsize, value, slope)
    done = bool(error <= TOL)
    s.update(count=count + 1, stepsize=new_stepsize, value=value, grad=grad, slope=slope,
             decrease_error=dec, interval_found=bool(set_high_to_new or set_low_to_new or done),
             done=done, failed=(count + 1 >= MAX_LINESEARCH_STEPS) and not done,
             low=low[0], value_low=low[1], slope_low=low[2],
             high=high[0], value_high=high[1], slope_high=high[2],
             cubic_ref=low[0], value_cubic_ref=low[1])


def _zoom_into_interval(s, objective, x, d, value_init, slope_init):
    """Algorithm 3.6: shrink the interval by cubic, quadratic or bisection
    steps."""
    count = s["count"]
    low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
    high, value_high, slope_high = s["high"], s["value_high"], s["slope_high"]
    delta = f32(abs(high - low))
    left, right = min(high, low), max(high, low)
    cubic_chk, quad_chk = f32(0.2) * delta, f32(0.1) * delta
    too_small_int = delta <= INTERVAL_THRESHOLD
    middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high, s["cubic_ref"],
                             s["value_cubic_ref"])
    middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
    if left + cubic_chk < middle_cubic < right - cubic_chk:
        middle = middle_cubic
    elif left + quad_chk < middle_quad < right - quad_chk:
        middle = middle_quad
    else:
        middle = f32((low + high) / f32(2.0))
    value, grad, slope = objective.on_line(x, float(middle), d)
    dec = _decrease_error(middle, value, slope, value_init, slope_init)
    curv = _curvature_error(slope, slope_init)
    error = max(dec, curv)
    if dec <= TOL and value < s["safe_value"]:
        s.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
    done = bool(error <= TOL)
    set_high_to_middle = (dec > 0.0) or (value >= value_low)
    set_high_to_low = (slope * (high - low) >= 0.0) and not set_high_to_middle
    new_high = (middle, value, slope) if set_high_to_middle else (high, value_high, slope_high)
    if set_high_to_low:
        new_high = (low, value_low, slope_low)
    new_low = (low, value_low, slope_low) if set_high_to_middle else (middle, value, slope)
    cubic = (high, value_high) if (set_high_to_middle or set_high_to_low) else (low, value_low)
    presumably_failed = ((count + 1 >= MAX_LINESEARCH_STEPS)
                         or (too_small_int and s["safe_stepsize"] > 0.0))
    s.update(count=count + 1, stepsize=middle, value=value, grad=grad, slope=slope,
             decrease_error=dec, done=done, failed=presumably_failed and not done,
             low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
             high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
             cubic_ref=cubic[0], value_cubic_ref=cubic[1])


class _Memory:
    """The ring of the last ``m`` (Δw, Δg, ρ) and the two-loop recursion
    (optax's ``scale_by_lbfgs``)."""

    def __init__(self, x: torch.Tensor, m: int = MEMORY_SIZE):
        self.m, self.count = m, 0
        self.dw = torch.zeros((m, x.numel()), dtype=x.dtype, device=x.device)
        self.dg = torch.zeros_like(self.dw)
        self.rho = torch.zeros(m, dtype=x.dtype, device=x.device)
        self.params = torch.zeros_like(x)
        self.grad = torch.zeros_like(x)

    def direction(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """P·g for the iterate ``x`` with gradient ``g``; records the pair."""
        m, count = self.m, self.count
        if count > 0:
            dw, dg = x - self.params, g - self.grad
            vdot = torch.dot(dg, dw)
            rho = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            denominator = torch.dot(dg, dg)
            scale = torch.where(denominator > 0.0, vdot / denominator,
                                torch.ones_like(vdot))
        else:
            dw, dg, rho = torch.zeros_like(x), torch.zeros_like(x), torch.zeros((), device=x.device)
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        prev = (count - 1) % m
        self.dw[prev], self.dg[prev], self.rho[prev] = dw, dg, rho
        indices = [(count % m + k) % m for k in range(m)]
        vec, alphas = g, {}
        for idx in reversed(indices):
            alphas[idx] = self.rho[idx] * torch.dot(self.dw[idx], vec)
            vec = vec + (-alphas[idx]) * self.dg[idx]
        vec = scale * vec
        for idx in indices:
            beta = self.rho[idx] * torch.dot(self.dg[idx], vec)
            vec = vec + (alphas[idx] - beta) * self.dw[idx]
        self.params, self.grad, self.count = x, g, count + 1
        return vec


def lbfgs_run(fun: Callable[[dict], torch.Tensor], params: dict[str, torch.Tensor],
              num_iters: int, record_iterates: bool = False, graph: bool = True):
    """``num_iters`` iterations of L-BFGS on ``fun(params) -> scalar`` from
    ``params`` (a dict of float32 tensors on one device). Returns (the final
    params, the objective at the start of each iteration (num_iters,), an
    :class:`LBFGSInfo`). ``graph``: on a CUDA device, each evaluation
    replays one captured CUDA graph (module doc); ``fun`` must then read
    only device tensors and copy nothing from the host."""
    x, unflatten = _flatten(params)
    info = LBFGSInfo()
    objective = _Objective(fun, unflatten, info, graph)
    memory = _Memory(x)
    values = []
    value = grad = None
    if record_iterates:
        info.iterates.append(unflatten(x.clone()))
    for _ in range(num_iters):
        if value is None or not torch.isfinite(value):
            value, grad = objective(x)
        values.append(value)
        d = -memory.direction(x, grad)
        stepsize, ls_value, ls_grad, steps = zoom_linesearch(objective, x, d, value, grad)
        x = x + float(stepsize) * d
        value = torch.as_tensor(ls_value, device=x.device)
        grad = ls_grad
        info.linesearch_steps.append(steps)
        if record_iterates:
            info.iterates.append(unflatten(x.clone()))
    out = unflatten(x)
    return ({k: v.clone() for k, v in out.items()},
            torch.stack(values) if values else torch.zeros(0), info)
