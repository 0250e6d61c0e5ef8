"""The plain reference of the structured latent-ODE VAE, written from the
model's equations ("Capturing Actionable Dynamics with Structured Latent
ODEs", UAI 2022; the reference repo's ``training_cvs.py`` and
``training_proc.py``) in plain PyTorch, float32.

It imports nothing of the program. The parameters are one flat dict from a
path such as ``encoder/lin/W`` to a tensor (``port_bench/weights.py`` makes
them from the seed and hands the same values to both sides); linear weights
are ``(out, in)``. The model's structure comes from the configuration file's
``model`` section.

- Encoder: conv1d (VALID) -> average pool (stride 1) -> flatten -> linear ->
  tanh -> a loc head and a clipped-exp scale head.
- Decoder: x0 = sigmoid(L2(relu(L1(z)))); dx/dt = a(t, z) - d(t, z) x with
  a, d sigmoid heads over relu(W [t, z] + b), integrated by the
  configuration's explicit Runge-Kutta tableau, step by step on the full
  right-hand side; three bias-free heads give the 25/50/75 % quantile bands
  over a softplus observation scale.
- Losses: one Trace_ELBO particle at the reparameterized sample (the MC KL
  form), summed over the unmasked samples; the quantile likelihood weighs an
  element tau where the target lies at or above the band, else 1 - tau.
- The draws: :mod:`port_bench.reference.sampler`, keyed (seed, site,
  sample_id) as the program documents them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from port_bench.reference.sampler import normal

Tensor = torch.Tensor
LOG_2PI = math.log(2.0 * math.pi)
CLIP = 1e-7
# a target this near a quantile band may fall on either side of it in float32:
# the program's bands differ from the reference's by about 1e-6 at most, over
# the bands' scale (served bands at 16,411 CVS trajectories on an H100, PERF.md);
# so may a decoder ReLU's pre-activation this near zero, whose side turns its
# unit's gradient on or off (a proc_sweep seed on an H100, PERF.md)
NEAR = 3e-6

# explicit Runge-Kutta tableaus (c, a, b)
TABLEAUS = {
    "euler": ((0.0,), ((),), (1.0,)),
    "midpoint": ((0.0, 0.5), ((), (0.5,)), (0.0, 1.0)),
    "heun": ((0.0, 1.0), ((), (1.0,)), (0.5, 0.5)),
    "rk4": ((0.0, 0.5, 0.5, 1.0), ((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)), (1 / 6, 1 / 3, 1 / 3, 1 / 6)),
}


class Model:
    """The model of one configuration file (its ``config`` and ``model``
    sections)."""

    def __init__(self, cfg: Dict):
        c, m = cfg["config"], cfg["model"]
        self.blocks = [(name, int(dim)) for name, dim in m["blocks"]]
        self.labels = [dict(name=n, dim=int(d), kind=k, block=b) for n, d, k, b in m["labels"]]
        self.prior = m["prior"]
        self.prior_input_order = list(m["prior_input_order"])
        self.aux_in_model = bool(m["aux_in_model"])
        # the label sites' multiplier at epoch 0, where the followed steps lie:
        # a warm-up's start where one is set, else the constant (an anneal
        # starts from it)
        warm_up = c.get("aux_warmup_epochs") and c.get("aux_mult_start") is not None
        self.aux_mult = float(c["aux_mult_start"] if warm_up else c["aux_loss_multiplier"])
        self.quantile_diff = float(c["quantile_diff"])
        self.pool = int(c["pool_size"])
        self.solver = c["solver"]
        self.lr = float(c["learning_rate"])
        self.near = []  # the decisions within round-off's reach (quantile bands, ReLU gates), noted by elbo_main

    def block_slice(self, name: str) -> slice:
        start = 0
        for b, dim in self.blocks:
            if b == name:
                return slice(start, start + dim)
            start += dim
        raise KeyError(name)

    @property
    def labeled(self):
        return self.blocks[:-1]

    @property
    def eps_dim(self) -> int:
        return self.blocks[-1][1]

    # -- the networks ---------------------------------------------------

    def encode(self, p, obs: Tensor):
        y = F.conv1d(obs, p["encoder/conv_W"], p["encoder/conv_b"])
        y = F.avg_pool1d(y, kernel_size=self.pool, stride=1).reshape(obs.shape[0], -1)
        h = torch.tanh(y @ p["encoder/lin/W"].T + p["encoder/lin/b"])
        loc = h @ p["encoder/z_loc/W"].T + p["encoder/z_loc/b"]
        scale = torch.exp(torch.clamp(h @ p["encoder/z_scale/W"].T + p["encoder/z_scale/b"], -30.0, 15.0))
        return loc, scale

    def prior_params(self, p, batch):
        """(loc, scale) of each conditional prior: one per labeled block, or
        one joint ``z_u`` over the labels in ``prior_input_order``."""
        def heads(prefix, x):
            loc = x @ p[f"{prefix}/heads/0/W"].T + p[f"{prefix}/heads/0/b"]
            scale = torch.exp(torch.clamp(x @ p[f"{prefix}/heads/1/W"].T + p[f"{prefix}/heads/1/b"], -30.0, 15.0))
            return loc, scale

        if self.prior == "separate":
            return {b: heads(f"priors/{b}", batch[next(l["name"] for l in self.labels if l["block"] == b)])
                    for b, _ in self.labeled}
        x = torch.cat([batch[name] for name in self.prior_input_order], dim=-1)
        return {"z_u": heads("priors/z_u", x)}

    def aux_head(self, p, label, z_block: Tensor):
        pre = f"aux/{label['name']}"
        h = F.softplus(z_block @ p[f"{pre}/hidden/0/W"].T + p[f"{pre}/hidden/0/b"])
        out = h @ p[f"{pre}/heads/0/W"].T + p[f"{pre}/heads/0/b"]
        if label["kind"] == "bernoulli":
            return torch.sigmoid(out)
        if label["kind"] == "onehot":
            return torch.softmax(out, dim=-1)
        return torch.exp(torch.clamp(out, -30.0, 15.0))  # a continuous label's loc

    def relu(self, x: Tensor, site: str, tag=None, flips=()) -> Tensor:
        """relu(x). With a ``tag``, where a gradient is taken, each
        pre-activation within :data:`NEAR` of zero, whose gate float32
        round-off decides, is noted in ``self.near`` as (``tag``, ``site``,
        element, distance); ``flips`` holds the (site, element) pairs whose
        gate is taken the other way."""
        if tag is not None and x.requires_grad:
            with torch.no_grad():
                dist = x.detach().abs().reshape(-1)
                for i in torch.nonzero(dist < NEAR).reshape(-1).tolist():
                    self.near.append((tag, site, i, float(dist[i])))
        mine = [i for s, i in flips if s == site]
        if not mine:
            return torch.relu(x)
        gate = (x > 0).reshape(-1).clone()
        gate[mine] = ~gate[mine]
        return torch.where(gate.reshape(x.shape), x, torch.zeros_like(x))

    def initial_state(self, p, z: Tensor, tag=None, flips=()) -> Tensor:
        h = self.relu(z @ p["decoder/ode/latent_to_ode/0/W"].T + p["decoder/ode/latent_to_ode/0/b"], "x0", tag, flips)
        return torch.sigmoid(h @ p["decoder/ode/latent_to_ode/1/W"].T + p["decoder/ode/latent_to_ode/1/b"])

    def rates(self, p, t: Tensor, z: Tensor, tag=None, flips=()):
        """Production a and degradation d at the times t ``(N,)``: each
        ``(B, N, D)``."""
        W, b = p["decoder/ode/dyn_hidden/W"], p["decoder/ode/dyn_hidden/b"]
        h = self.relu((z @ W[:, 1:].T + b)[:, None, :] + t[None, :, None] * W[:, 0], "rates", tag, flips)
        a = torch.sigmoid(h @ p["decoder/ode/prod/W"].T + p["decoder/ode/prod/b"])
        d = torch.sigmoid(h @ p["decoder/ode/degr/W"].T + p["decoder/ode/degr/b"])
        return a, d

    def solve(self, p, z: Tensor, ts: Tensor, tag=None, flips=()) -> Tensor:
        """The state trajectory ``(B, T, D)``, x0 included: each step of the
        tableau on dx/dt = a - d x (``tag`` and ``flips`` for the ReLU
        gates, :meth:`relu`)."""
        c, a_tab, b_tab = TABLEAUS[self.solver]
        h = ts[1:] - ts[:-1]
        stage_t = torch.stack([ts[:-1] + h * ci for ci in c], dim=1).reshape(-1)
        a, d = self.rates(p, stage_t, z, tag, flips)
        S = len(c)
        a = a.reshape(z.shape[0], -1, S, a.shape[-1])
        d = d.reshape(z.shape[0], -1, S, d.shape[-1])
        x = self.initial_state(p, z, tag, flips)
        out = [x]
        for n in range(ts.shape[0] - 1):
            ks = []
            for i, row in enumerate(a_tab):
                y = x
                for aij, kj in zip(row, ks):
                    if aij != 0.0:
                        y = y + h[n] * aij * kj
                ks.append(a[:, n, i] - d[:, n, i] * y)
            x = x + sum(h[n] * bi * ki for bi, ki in zip(b_tab, ks) if bi != 0.0)
            out.append(x)
        return torch.stack(out, dim=1)

    def decode(self, p, z: Tensor, ts: Tensor, tag=None, flips=()):
        """(solution, mu_75, mu_50, mu_25, std), the bands ``(B, K, T)``."""
        sol = self.solve(p, z, ts, tag, flips)
        band = {q: (sol @ p[f"decoder/{q}/W"].T).transpose(1, 2) for q in ("q75", "q50", "q25")}
        std = (F.softplus(p["decoder/constant_std"]) + 1e-6).expand(band["q50"].shape)
        return sol, band["q75"], band["q50"], band["q25"], std

    # -- log densities ----------------------------------------------------

    @staticmethod
    def normal_logpdf(x, loc, scale):
        z = (x - loc) / scale
        return -0.5 * z * z - torch.log(scale) - 0.5 * LOG_2PI

    @staticmethod
    def laplace_logpdf(x, loc, scale):
        return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)

    def label_logp(self, p, label, z_block: Tensor, target: Tensor) -> Tensor:
        """log q(u | z) of one label, per sample."""
        out = self.aux_head(p, label, z_block)
        if label["kind"] == "bernoulli":
            q = torch.clamp(out, CLIP, 1.0 - CLIP)
            return (target * torch.log(q) + (1.0 - target) * torch.log1p(-q)).sum(-1)
        if label["kind"] == "onehot":
            return (target * torch.log(torch.clamp(out, CLIP, 1.0))).sum(-1)
        std = F.softplus(p[f"aux_std/{label['name']}"]) + 1e-6
        return self.laplace_logpdf(target, out, std).sum(-1)

    # -- the two losses ---------------------------------------------------

    def elbo_main(self, p, seed: int, batch, ts: Tensor, tag=None, flips=()) -> Tensor:
        """Minus the ELBO of the generative model and guide, summed over the
        unmasked samples.

        A quantile band's element weighs tau where the target lies at or
        above it, else 1 - tau, and its |target - band| turns there: a
        decision that float32 round-off takes where the two lie within it.
        Each element whose target lies within :data:`NEAR` of a band is
        noted in ``self.near`` as (``tag``, band, element, distance);
        ``flips`` holds the (band, element) pairs of this call whose
        decision is taken the other way, and the decoder's ReLU gates'
        (site, element) pairs likewise (:meth:`relu`)."""
        obs, sids = batch["observations"], batch["sample_id"]
        loc, scale = self.encode(p, obs)
        prior = self.prior_params(p, batch)
        terms = obs.new_zeros(obs.shape[0])
        zs = []
        if self.prior == "separate":
            for b, _ in self.labeled:
                s = self.block_slice(b)
                z_b = normal(seed, f"main/{b}", sids, loc[:, s], scale[:, s])
                terms = terms + (self.normal_logpdf(z_b, *prior[b]) - self.normal_logpdf(z_b, loc[:, s], scale[:, s])).sum(-1)
                zs.append(z_b)
        else:
            n = sum(dim for _, dim in self.labeled)
            z_u = normal(seed, "main/z_u", sids, loc[:, :n], scale[:, :n])
            terms = terms + (self.normal_logpdf(z_u, *prior["z_u"]) - self.normal_logpdf(z_u, loc[:, :n], scale[:, :n])).sum(-1)
            zs.append(z_u)
        e = self.eps_dim
        z_e = normal(seed, f"main/{self.blocks[-1][0]}", sids, loc[:, -e:], scale[:, -e:])
        terms = terms + (self.normal_logpdf(z_e, torch.zeros_like(z_e), torch.ones_like(z_e))
                         - self.normal_logpdf(z_e, loc[:, -e:], scale[:, -e:])).sum(-1)
        z = torch.cat(zs + [z_e], dim=-1)
        if self.aux_in_model:
            for label in self.labels:
                terms = terms + self.aux_mult * self.label_logp(p, label, z[:, self.block_slice(label["block"])],
                                                                batch[label["name"]])
        _, mu_75, mu_50, mu_25, std = self.decode(p, z, ts, tag, flips)
        qd = self.quantile_diff
        for band, (mu, tau) in enumerate(((mu_50, 0.5), (mu_75, 0.5 + qd), (mu_25, 0.5 - qd))):
            d = obs - mu
            above = d >= 0
            with torch.no_grad():
                dist = d.abs().reshape(-1)
                for i in torch.nonzero(dist < NEAR).reshape(-1).tolist():
                    self.near.append((tag, band, i, float(dist[i])))
            mine = [i for b, i in flips if b == band]
            if mine:
                above = above.reshape(-1).clone()
                above[mine] = ~above[mine]
                above = above.reshape(d.shape)
            sign = torch.where(above, 1.0, -1.0)
            w = torch.where(above, tau, 1.0 - tau)
            terms = terms + (w * (-(sign * d) / std - torch.log(2.0 * std))).sum((-2, -1))
        return -(terms * batch["mask"]).sum()

    def elbo_aux(self, p, seed: int, batch) -> Tensor:
        """Minus the auxiliary ELBO: each labeled block drawn from the
        encoder in the model (its log density counts), then the scaled label
        sites."""
        obs, sids = batch["observations"], batch["sample_id"]
        loc, scale = self.encode(p, obs)
        terms = obs.new_zeros(obs.shape[0])
        zb = {}
        for b, _ in self.labeled:
            s = self.block_slice(b)
            zb[b] = normal(seed, f"aux/{b}", sids, loc[:, s], scale[:, s])
            terms = terms + self.normal_logpdf(zb[b], loc[:, s], scale[:, s]).sum(-1)
        for label in self.labels:
            terms = terms + self.aux_mult * self.label_logp(p, label, zb[label["block"]], batch[label["name"]])
        return -(terms * batch["mask"]).sum()

    # -- serving: the reference of a served request (a serving cell's, PERF.md) --

    def recon_post(self, p, seed: int, obs: Tensor, ts: Tensor, sample_ids: Optional[Tensor] = None):
        """The posterior reconstruction: z from the encoder at site
        ``posterior``, decoded. Returns a dict of z and the bands."""
        sids = torch.arange(obs.shape[0], device=obs.device) if sample_ids is None else sample_ids
        loc, scale = self.encode(p, obs)
        z = normal(seed, "posterior", sids, loc, scale)
        sol, mu_75, mu_50, mu_25, std = self.decode(p, z, ts)
        return {"z": z, "solution_xt": sol, "mu_75": mu_75, "mu_50": mu_50, "mu_25": mu_25, "std": std}

    def classify(self, p, seed: int, obs: Tensor, sample_ids: Optional[Tensor] = None):
        """Each label from a posterior draw at site ``classifier/<label>``:
        bernoulli thresholded at 0.5, onehot as its argmax, continuous its
        regressed loc. Returns the labels and, per label, each sample's
        margin: how far its probability lies from the decision (|q - 0.5|,
        or the top two classes' difference; 0 for a continuous label)."""
        sids = torch.arange(obs.shape[0], device=obs.device) if sample_ids is None else sample_ids
        loc, scale = self.encode(p, obs)
        out, margins = {}, {}
        for label in self.labels:
            s = self.block_slice(label["block"])
            q = self.aux_head(p, label, normal(seed, f"classifier/{label['name']}", sids, loc[:, s], scale[:, s]))
            if label["kind"] == "bernoulli":
                out[label["name"]] = (q > 0.5).to(obs.dtype)
                margins[label["name"]] = (q - 0.5).abs()
            elif label["kind"] == "onehot":
                out[label["name"]] = F.one_hot(q.argmax(-1), label["dim"]).to(obs.dtype)
                top = q.topk(2, dim=-1).values
                margins[label["name"]] = (top[..., :1] - top[..., 1:]).expand_as(q)
            else:
                out[label["name"]] = q
                margins[label["name"]] = torch.zeros_like(q)
        return out, margins
