"""Plain neural topology optimization, written from the method's
definition: a Fourier-feature MLP maps each element's coordinates to a
logit; a shift b, the root of mean(sigmoid(out + b)) = V, makes the
density meet the volume exactly; the compliance f^T u of that density,
with u from the reference's own solve, is the loss; its gradient flows
back through the shift by the implicit-function theorem and through the
network; Adam updates the weights.

The network is drawn from the seed as the method's initialisation says:
the Fourier matrix B ~ N(0, 1) sigma and orthogonal layer weights (gain
sqrt(max(neurons / embedding, 1))) from one CPU generator in float64, in
that order; zero biases; then the last layer set to 1e-4 N(0, 1) from a
generator seeded 0, and its bias to V, so that the first density is
uniform."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import torch
from torch import nn

from benchmark.reference import fem, solve
from benchmark.reference.precision import exact_float32, fp32_linear

CHUNK = 1 << 17


@dataclasses.dataclass
class Net:
    B: torch.Tensor
    params: List[torch.Tensor]    # W1, b1, W2, b2, ... (the program's order)


def init(seed: int, embedding: int, neurons: int, layers: int, sigma: float,
         volume: float, device) -> Net:
    gen = torch.Generator().manual_seed(seed)
    B = torch.randn((embedding, 3), generator=gen, dtype=torch.float64) * sigma
    sizes = [2 * embedding] + [neurons] * (layers - 1) + [1]
    gain = math.sqrt(max(neurons / embedding, 1.0))
    params = []
    for i in range(layers):
        w = torch.empty((sizes[i + 1], sizes[i]), dtype=torch.float64)
        nn.init.orthogonal_(w, gain=gain, generator=gen)
        params += [w, torch.zeros(sizes[i + 1], dtype=torch.float64)]
    g0 = torch.Generator().manual_seed(0)
    params[-2] = 1e-4 * torch.randn(params[-2].shape, generator=g0, dtype=torch.float64)
    params[-1] = torch.full_like(params[-1], volume)
    return Net(B.to(device, torch.float32),
               [p.to(device, torch.float32) for p in params])


def coordinates(dims, device) -> torch.Tensor:
    """The element grid's coordinates in [0, 1]^3, flattened (n, 3)."""
    axes = [torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device) for n in dims]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


def forward(net: Net, x: torch.Tensor, params, linear: Callable = fp32_linear) -> torch.Tensor:
    proj = torch.matmul(2.0 * math.pi * x, net.B.t())
    h = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    n = len(params) // 2
    for i in range(n):
        h = linear(h, params[2 * i], params[2 * i + 1])
        if i < n - 1:
            h = torch.relu(h)
    return h[:, 0]


def _shift(out: torch.Tensor, volume: float) -> float:
    """b with mean(sigmoid(out + b)) = volume, by bisection in float64."""
    logit = math.log(volume / (1 - volume))
    lo, hi = logit - float(out.max()), logit - float(out.min())
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if float(torch.sigmoid(out + mid).mean()) > volume:
            hi = mid
        else:
            lo = mid
        if hi - lo < 1e-15 * max(1.0, abs(mid)):
            break
    return 0.5 * (lo + hi)


@dataclasses.dataclass
class Step:
    loss: float
    grads: List[torch.Tensor]
    cg_iters: int
    residual: float


def loss_and_grads(prob: fem.Problem, net: Net, params, coords, tol: float,
                   linear: Callable = fp32_linear) -> Step:
    """The loss f^T u at ``params`` and its gradient, the network in chunks
    of points (forward without the graph, then each chunk again with it)."""
    with torch.no_grad():
        out = torch.cat([forward(net, c, params, linear) for c in torch.split(coords, CHUNK)])
    out64 = out.double()
    b = _shift(out64, prob.volume)
    rho = torch.sigmoid(out64 + b).reshape(prob.dims)
    u, iters, rel = solve.solve(prob, rho, tol)
    loss = float(torch.sum(prob.force * u))
    g_rho = fem.compliance_grad_rho(prob, rho, u).reshape(-1)
    s = (rho * (1 - rho)).reshape(-1)
    g_out = (s * g_rho - s * torch.sum(s * g_rho) / torch.sum(s)).float()
    leaves = [p.detach().requires_grad_(True) for p in params]
    for c, g in zip(torch.split(coords, CHUNK), torch.split(g_out, CHUNK)):
        torch.autograd.backward(forward(net, c, leaves, linear), g)
    return Step(loss, [p.grad for p in leaves], iters, rel)


class Adam:
    """Adam as torch.optim.Adam computes it (no weight decay)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = []
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            out.append(p - (self.lr / c1) * m / (v.sqrt() / math.sqrt(c2) + self.eps))
        return out


@dataclasses.dataclass
class Trajectory:
    losses: List[float]
    first_grads: List[torch.Tensor]
    params: List[List[torch.Tensor]]   # before step 0, 1, ...
    cg_iters: List[int]
    residuals: List[float]


def follow(prob: fem.Problem, net: Net, dims, steps: int, lr: float, tol: float,
           linear: Callable = fp32_linear) -> Trajectory:
    """The first ``steps`` Adam steps from the drawn network."""
    exact_float32()
    coords = coordinates(dims, net.B.device)
    params = list(net.params)
    opt = Adam(params, lr)
    tr = Trajectory([], [], [params], [], [])
    for k in range(steps):
        st = loss_and_grads(prob, net, params, coords, tol, linear)
        if k == 0:
            tr.first_grads = st.grads
        tr.losses.append(st.loss)
        tr.cg_iters.append(st.cg_iters)
        tr.residuals.append(st.residual)
        params = opt.step(params, st.grads)
        tr.params.append(params)
    return tr


def leaf_gap(prog: List[torch.Tensor], ref: List[torch.Tensor], keep=None) -> float:
    """Worst leaf's | ||prog|| - ||ref|| | over max(||ref||, median leaf
    ||ref||), over the leaves ``keep`` marks."""
    norms = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = sorted(norms)[len(norms) // 2]
    gaps = [abs(float(torch.linalg.vector_norm(p.double().to(r.device))) - n) / max(n, med)
            for p, r, n in zip(prog, ref, norms)]
    keep = keep or [True] * len(gaps)
    return max(g for g, k in zip(gaps, keep) if k)


def leaf_diff(prog: List[torch.Tensor], ref: List[torch.Tensor], keep=None) -> float:
    """Worst leaf's ||prog - ref|| over max(||ref||, median leaf ||ref||)."""
    norms = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = sorted(norms)[len(norms) // 2]
    gaps = [float(torch.linalg.vector_norm(p.double().to(r.device) - r.double())) / max(n, med)
            for p, r, n in zip(prog, ref, norms)]
    keep = keep or [True] * len(gaps)
    return max(g for g, k in zip(gaps, keep) if k)


def moving_leaves(first_grads: List[torch.Tensor]) -> List[bool]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others (the last bias, whose shift the volume
    constraint takes back) move under Adam by round-off alone."""
    norms = [float(torch.linalg.vector_norm(g.double())) for g in first_grads]
    med = sorted(norms)[len(norms) // 2]
    return [n >= 1e-3 * med for n in norms]
