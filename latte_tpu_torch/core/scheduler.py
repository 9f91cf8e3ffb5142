"""The ten inference schedulers of the T2V pipeline (port of
``latte_tpu/core/scheduler.py``).

Diffusers-style timestep spacing (``timesteps(n)``: ``n`` leading-spaced
training indices, descending), not the respaced engine of
:mod:`latte_tpu_torch.core.diffusion`. Each scheduler is a frozen dataclass
with the JAX package's config keys; its per-step state is a dict that
``step`` returns anew: host values (flags, counters) and tensors (saved
samples and predictions), so the sampling loop reads ``state["in_correction"]``
without a device sync. The scalar coefficients are 0-d fp32 CPU tensors
computed as the JAX package computes them in fp32, then broadcast onto the
latents on their device.

Stochastic steps (DDPM, the ancestral family, DDIM with ``eta > 0``:
``needs_noise``) take the step's standard-normal draw as an explicit
``noise`` tensor, which the pipeline draws from its ``torch.Generator``
(and a test hands over from the JAX draws); without it they add no noise.

DDIM, DDPM, EulerDiscrete, EulerAncestralDiscrete, HeunDiscrete
(interleaved predictor/corrector), DPMSolverMultistep (DPM-Solver++ 2M),
DPMSolverSinglestep (2S), DEISMultistep (logrho order 2), PNDM (PRK
prologue and PLMS body) and KDPM2AncestralDiscrete (interleaved).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from latte_tpu_torch.core.schedules import get_named_beta_schedule

__all__ = ["get_scheduler", "SCHEDULERS"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class BaseScheduler:
    """The shared alpha tables (fp64 numpy, and fp32 CPU for the steps)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"
    # two model calls per grid interval (predictor and corrector at the same
    # index): the sampling loop repeats the index while state["in_correction"] is set
    interleaved: bool = False

    def __post_init__(self):
        T = self.num_train_timesteps
        if self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, T, dtype=np.float64)
        elif self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start**0.5, self.beta_end**0.5, T, dtype=np.float64) ** 2
        else:
            betas = get_named_beta_schedule(self.beta_schedule, T)
        object.__setattr__(self, "betas", betas)
        object.__setattr__(self, "alphas_cumprod", np.cumprod(1.0 - betas))
        object.__setattr__(self, "_ac", _f32(self.alphas_cumprod))

    @property
    def needs_noise(self) -> bool:
        """Whether ``step`` adds a standard-normal draw (``noise``)."""
        return False

    def init_noise_sigma_for(self, num_inference_steps: int) -> float:
        """Scale of the initial x_T draw (diffusers ``init_noise_sigma``)."""
        return 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending training-timestep indices (leading spacing)."""
        step = self.num_train_timesteps // num_inference_steps
        return (np.arange(num_inference_steps) * step).round()[::-1].astype(np.int64)

    def scale_model_input(self, sample: torch.Tensor, i: int, state) -> torch.Tensor:
        return sample

    def model_timestep(self, i: int, ts: np.ndarray, state) -> float:
        """The (fp32, possibly fractional) timestep the model is conditioned
        on for call ``i``; the interleaved correctors evaluate later."""
        return float(ts[i])

    def init_state(self, num_inference_steps: int) -> Dict[str, Any]:
        return {}

    def _pred_x0(self, model_output, sample, alpha_bar):
        if self.prediction_type == "epsilon":
            return (sample - torch.sqrt(1 - alpha_bar) * model_output) / torch.sqrt(alpha_bar)
        if self.prediction_type == "sample":
            return model_output
        if self.prediction_type == "v_prediction":
            return torch.sqrt(alpha_bar) * sample - torch.sqrt(1 - alpha_bar) * model_output
        raise NotImplementedError(self.prediction_type)

    def _pred_eps(self, model_output, sample, alpha_bar):
        if self.prediction_type == "epsilon":
            return model_output
        x0 = self._pred_x0(model_output, sample, alpha_bar)
        return (sample - torch.sqrt(alpha_bar) * x0) / torch.sqrt(1 - alpha_bar)

    def _alpha_prev(self, i: int, ts: np.ndarray) -> torch.Tensor:
        return self._ac[int(ts[i + 1])] if i + 1 < len(ts) else _f32(1.0)


@dataclasses.dataclass(frozen=True)
class DDIMScheduler(BaseScheduler):
    clip_sample: bool = False
    eta: float = 0.0

    @property
    def needs_noise(self) -> bool:
        return self.eta > 0

    def step(self, model_output, i, ts, sample, state, noise=None):
        alpha_bar = self._ac[int(ts[i])]
        alpha_prev = self._alpha_prev(i, ts)
        x0 = self._pred_x0(model_output, sample, alpha_bar)
        if self.clip_sample:
            x0 = x0.clamp(-1, 1)
        eps = self._pred_eps(model_output, sample, alpha_bar)
        sigma = self.eta * torch.sqrt((1 - alpha_prev) / (1 - alpha_bar) * (1 - alpha_bar / alpha_prev))
        prev = torch.sqrt(alpha_prev) * x0 + torch.sqrt(1 - alpha_prev - sigma**2) * eps
        if self.eta > 0 and noise is not None:
            prev = prev + sigma * noise
        return prev, state


@dataclasses.dataclass(frozen=True)
class DDPMScheduler(BaseScheduler):
    clip_sample: bool = True
    variance_type: str = "fixed_small"

    @property
    def needs_noise(self) -> bool:
        return True

    def step(self, model_output, i, ts, sample, state, noise=None):
        t = int(ts[i])
        alpha_bar = self._ac[t]
        alpha_prev = self._alpha_prev(i, ts)
        cur_alpha = alpha_bar / alpha_prev
        cur_beta = 1 - cur_alpha
        x0 = self._pred_x0(model_output, sample, alpha_bar)
        if self.clip_sample:
            x0 = x0.clamp(-1, 1)
        coef_x0 = torch.sqrt(alpha_prev) * cur_beta / (1 - alpha_bar)
        coef_xt = torch.sqrt(cur_alpha) * (1 - alpha_prev) / (1 - alpha_bar)
        mean = coef_x0 * x0 + coef_xt * sample
        if self.variance_type == "fixed_small":
            var = ((1 - alpha_prev) / (1 - alpha_bar) * cur_beta).clamp(min=1e-20)
        elif self.variance_type == "fixed_large":
            var = cur_beta.clamp(min=1e-20)
        else:
            raise NotImplementedError(
                f"variance_type {self.variance_type!r}: only fixed_small / fixed_large (learned "
                "variances go through the respaced engine, core/diffusion.py)"
            )
        if noise is None or t <= 0:
            return mean, state
        return mean + torch.sqrt(var) * noise, state


class _KarrasMixin:
    """sigma-space machinery of the Euler, Heun and KDPM2 schedulers."""

    def sigmas(self, num_inference_steps: int) -> np.ndarray:
        ac = self.alphas_cumprod
        all_sigmas = np.sqrt((1 - ac) / ac)
        return np.append(all_sigmas[self.timesteps(num_inference_steps)], 0.0)

    def init_noise_sigma_for(self, num_inference_steps: int) -> float:
        return float(np.sqrt(self.sigmas(num_inference_steps)[0] ** 2 + 1))

    def scale_model_input(self, sample, i, state):
        return sample / torch.sqrt(state["sigmas"][i] ** 2 + 1)

    def init_state(self, num_inference_steps):
        return {"sigmas": _f32(self.sigmas(num_inference_steps))}

    def _x0_from_sigma(self, model_output, sample, sigma):
        if self.prediction_type == "epsilon":
            return sample - sigma * model_output
        if self.prediction_type == "v_prediction":
            return model_output * (-sigma / torch.sqrt(sigma**2 + 1)) + sample / (sigma**2 + 1)
        return model_output


def _ancestral(sig, sig_next):
    """(sigma_up, sigma_down) of an ancestral step from sig to sig_next."""
    sigma_up = torch.sqrt((sig_next**2 * (sig**2 - sig_next**2) / sig**2).clamp(min=0.0))
    return sigma_up, torch.sqrt((sig_next**2 - sigma_up**2).clamp(min=0.0))


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler(_KarrasMixin, BaseScheduler):
    def step(self, model_output, i, ts, sample, state, noise=None):
        sig, sig_next = state["sigmas"][i], state["sigmas"][i + 1]
        x0 = self._x0_from_sigma(model_output, sample, sig)
        d = (sample - x0) / sig
        return sample + d * (sig_next - sig), state


@dataclasses.dataclass(frozen=True)
class EulerAncestralDiscreteScheduler(_KarrasMixin, BaseScheduler):
    @property
    def needs_noise(self) -> bool:
        return True

    def step(self, model_output, i, ts, sample, state, noise=None):
        sig, sig_next = state["sigmas"][i], state["sigmas"][i + 1]
        x0 = self._x0_from_sigma(model_output, sample, sig)
        sigma_up, sigma_down = _ancestral(sig, sig_next)
        d = (sample - x0) / sig
        prev = sample + d * (sigma_down - sig)
        if noise is not None:
            prev = prev + sigma_up * noise
        return prev, state


@dataclasses.dataclass(frozen=True)
class HeunDiscreteScheduler(_KarrasMixin, BaseScheduler):
    """Heun's second-order method: one call the Euler predictor, the next
    (at the same index, ``interleaved``) the corrector at sigma_{i+1}."""

    interleaved: bool = True

    def init_state(self, num_inference_steps):
        return {"sigmas": _f32(self.sigmas(num_inference_steps)), "prev_derivative": None,
                "sample": None, "in_correction": False}

    def _sigma(self, i, state):
        return state["sigmas"][i + 1] if state["in_correction"] else state["sigmas"][i]

    def scale_model_input(self, sample, i, state):
        return sample / torch.sqrt(self._sigma(i, state) ** 2 + 1)

    def model_timestep(self, i, ts, state):
        return float(ts[min(i + 1, len(ts) - 1)] if state["in_correction"] else ts[i])

    def step(self, model_output, i, ts, sample, state, noise=None):
        sig, sig_next = state["sigmas"][i], state["sigmas"][i + 1]
        in_corr = state["in_correction"]
        sigma = self._sigma(i, state)
        x0 = self._x0_from_sigma(model_output, sample, sigma)
        d = (sample - x0) / sigma
        dt = sig_next - sig
        if in_corr:
            prev = state["sample"] + 0.5 * (state["prev_derivative"] + d) * dt
            return prev, dict(state, in_correction=False)
        return sample + d * dt, dict(state, prev_derivative=d, sample=sample,
                                     in_correction=bool(sig_next > 0))


def _log_snr_tables(scheduler, num_inference_steps: int) -> Dict[str, torch.Tensor]:
    """alpha, sigma and lambda = log(alpha / sigma) at the timesteps, with a
    terminal entry (alpha 1, sigma 1e-4)."""
    ac = scheduler.alphas_cumprod[scheduler.timesteps(num_inference_steps)]
    alpha, sigma = np.sqrt(ac), np.sqrt(1 - ac)
    lam = np.log(alpha) - np.log(sigma)
    return {
        "alpha": _f32(np.append(alpha, 1.0)),
        "sigma": _f32(np.append(sigma, 1e-4)),
        "lam": _f32(np.append(lam, np.log(1.0) - np.log(1e-4))),
    }


@dataclasses.dataclass(frozen=True)
class DPMSolverMultistepScheduler(BaseScheduler):
    """DPM-Solver++ (2M): second-order multistep in log-SNR space."""

    solver_order: int = 2

    def init_state(self, num_inference_steps):
        return {**_log_snr_tables(self, num_inference_steps), "m0": None}

    def step(self, model_output, i, ts, sample, state, noise=None):
        x0 = self._pred_x0(model_output, sample, self._ac[int(ts[i])])
        s_s, l_s = state["sigma"][i], state["lam"][i]
        a_t, s_t, l_t = state["alpha"][i + 1], state["sigma"][i + 1], state["lam"][i + 1]
        h = l_t - l_s
        prev = (s_t / s_s) * sample - a_t * torch.expm1(-h) * x0
        if state["m0"] is not None and self.solver_order >= 2:
            h_prev = l_s - state["lam"][max(i - 1, 0)]
            r = h_prev / h if h_prev != 0 else _f32(1.0)
            d1 = (x0 - state["m0"]) / (r if r != 0 else _f32(1.0))
            prev = prev - 0.5 * a_t * torch.expm1(-h) * d1
        return prev, dict(state, m0=x0)


@dataclasses.dataclass(frozen=True)
class DPMSolverSinglestepScheduler(DPMSolverMultistepScheduler):
    """DPM-Solver++ (2S): a predictor call (1S to the next grid index) and
    a corrector call (the 2S jump from the saved start), alternating; with
    an odd number of calls the last is a 1S update."""

    def init_state(self, num_inference_steps):
        return {**_log_snr_tables(self, num_inference_steps), "x_s": None, "x0_1": None,
                "start_i": 0, "in_correction": False}

    def step(self, model_output, i, ts, sample, state, noise=None):
        x0_here = self._pred_x0(model_output, sample, self._ac[int(ts[i])])
        l_s = state["lam"][i]
        if not state["in_correction"]:
            s_s = state["sigma"][i]
            a_m, s_m, l_m = state["alpha"][i + 1], state["sigma"][i + 1], state["lam"][i + 1]
            prev = (s_m / s_s) * sample - a_m * torch.expm1(-(l_m - l_s)) * x0_here
            return prev, dict(state, x_s=sample, x0_1=x0_here, start_i=i, in_correction=True)
        si = state["start_i"]
        s_s0, l_s0 = state["sigma"][si], state["lam"][si]
        a_t, s_t, l_t = state["alpha"][i + 1], state["sigma"][i + 1], state["lam"][i + 1]
        h = l_t - l_s0
        r = (l_s - l_s0) / h if h != 0 else _f32(0.5)
        x0_1 = state["x0_1"]
        d = (x0_here - x0_1) / (r if r != 0 else _f32(1.0))
        prev = ((s_t / s_s0) * state["x_s"] - a_t * torch.expm1(-h) * x0_1
                - 0.5 * a_t * torch.expm1(-h) * d)
        return prev, dict(state, in_correction=False)


@dataclasses.dataclass(frozen=True)
class DEISMultistepScheduler(DPMSolverMultistepScheduler):
    """DEIS, logrho order 2: the eps prediction extrapolated linearly in
    rho = sigma / alpha and integrated exactly."""

    @staticmethod
    def _ind_fn(t, b, c):
        return t * (torch.log(c) - torch.log(t) + 1.0) / (torch.log(c) - torch.log(b))

    def step(self, model_output, i, ts, sample, state, noise=None):
        eps = self._pred_eps(model_output, sample, self._ac[int(ts[i])])
        a_s, s_s, l_s = state["alpha"][i], state["sigma"][i], state["lam"][i]
        a_t, s_t, l_t = state["alpha"][i + 1], state["sigma"][i + 1], state["lam"][i + 1]
        if state["m0"] is not None and self.solver_order >= 2:
            i_prev = max(i - 1, 0)
            rho_t, rho_s0 = s_t / a_t, s_s / a_s
            rho_s1 = state["sigma"][i_prev] / state["alpha"][i_prev]
            coef1 = self._ind_fn(rho_t, rho_s0, rho_s1) - self._ind_fn(rho_s0, rho_s0, rho_s1)
            coef2 = self._ind_fn(rho_t, rho_s1, rho_s0) - self._ind_fn(rho_s0, rho_s1, rho_s0)
            prev = a_t * (sample / a_s + coef1 * eps + coef2 * state["m0"])
        else:
            prev = (a_t / a_s) * sample - s_t * torch.expm1(l_t - l_s) * eps
        return prev, dict(state, m0=eps)


@dataclasses.dataclass(frozen=True)
class PNDMScheduler(BaseScheduler):
    """PNDM: a pseudo Runge-Kutta prologue (12 calls over the 3 highest
    intervals) and a PLMS (Adams-Bashforth up to order 4) body;
    ``timesteps(n)`` is the call sequence. ``skip_prk_steps`` starts PLMS at
    once with a Heun-like second call (n + 1 calls)."""

    skip_prk_steps: bool = False
    set_alpha_to_one: bool = False

    def _base_grid(self, num_inference_steps: int):
        step = self.num_train_timesteps // num_inference_steps
        return (np.arange(num_inference_steps) * step).round().astype(np.int64), step

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        grid, step = self._base_grid(num_inference_steps)
        if self.skip_prk_steps:
            seq = np.concatenate([grid[:-1], grid[-2:-1], grid[-1:]])[::-1]
        else:
            if num_inference_steps < 4:
                raise ValueError("the PNDM prologue needs >= 4 steps")
            prk = np.array(grid[-4:]).repeat(2) + np.tile(np.array([0, step // 2]), 4)
            prk = (prk[:-1].repeat(2)[1:-1])[::-1]
            seq = np.concatenate([prk, grid[:-3][::-1]])
        return seq.astype(np.int64)

    def init_state(self, num_inference_steps):
        # ets: the newest model outputs, oldest first, at most 4
        return {"ets": [], "cur_model_output": None, "cur_sample": None,
                "step_ratio": self._base_grid(num_inference_steps)[1]}

    def _prev_sample(self, sample, t, prev_t, model_output):
        """The PNDM transfer step phi(x, t, t_prev, eps) (diffusers
        ``PNDMScheduler._get_prev_sample``)."""
        T = self.num_train_timesteps
        alpha_t = self._ac[min(max(t, 0), T - 1)]
        if prev_t >= 0:
            alpha_prev = self._ac[min(prev_t, T - 1)]
        else:
            alpha_prev = _f32(1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0]))
        beta_t, beta_prev = 1 - alpha_t, 1 - alpha_prev
        if self.prediction_type == "v_prediction":
            model_output = torch.sqrt(alpha_t) * model_output + torch.sqrt(beta_t) * sample
        sample_coeff = torch.sqrt(alpha_prev / alpha_t)
        denom = alpha_t * torch.sqrt(beta_prev) + torch.sqrt(alpha_t * beta_t * alpha_prev)
        return sample_coeff * sample - (alpha_prev - alpha_t) * model_output / denom

    def step(self, model_output, i, ts, sample, state, noise=None):
        if not self.skip_prk_steps and i < 12:
            return self._prk_step(model_output, i, ts, sample, state)
        step_ratio, t_eval = state["step_ratio"], int(ts[i])
        ets = state["ets"]
        if i != 1:  # the second PLMS call re-steps with the averaged eps
            ets = (ets + [model_output])[-4:]
        e = ets[::-1]  # newest first
        n = len(ets)
        if n == 1:
            used = model_output if i == 0 else (model_output + e[0]) / 2
        elif n == 2:
            used = (3 * e[0] - e[1]) / 2
        elif n == 3:
            used = (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12
        else:
            used = (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24
        if i == 1:
            prev = self._prev_sample(state["cur_sample"], t_eval + step_ratio, t_eval, used)
        else:
            prev = self._prev_sample(sample, t_eval, t_eval - step_ratio, used)
        cur_sample = sample if i == 0 else state["cur_sample"]
        return prev, dict(state, ets=ets, cur_model_output=None, cur_sample=cur_sample)

    def _prk_step(self, model_output, i, ts, sample, state):
        """Call i of the three RK4 groups (4 calls each)."""
        k = i % 4
        t_eval = int(ts[i])
        prev_t = t_eval - (state["step_ratio"] // 2 if i % 2 == 0 else 0)
        t = int(ts[min((i // 4) * 4, len(ts) - 1)])
        cmo = state["cur_model_output"]
        if cmo is None:
            cmo = torch.zeros_like(model_output)
        if k == 0:
            new_cmo, used = cmo + model_output / 6, model_output
        elif k == 3:
            new_cmo, used = None, cmo + model_output / 6
        else:
            new_cmo, used = cmo + model_output / 3, model_output
        cur_sample = sample if k == 0 else state["cur_sample"]
        prev = self._prev_sample(cur_sample, t, prev_t, used)
        ets = (state["ets"] + [model_output])[-4:] if k == 0 else state["ets"]
        return prev, dict(state, ets=ets, cur_model_output=new_cmo, cur_sample=cur_sample)


@dataclasses.dataclass(frozen=True)
class KDPM2AncestralDiscreteScheduler(EulerAncestralDiscreteScheduler):
    """KDPM2 ancestral: per sigma interval a predictor call (to the
    log-space midpoint of sigma_i and sigma_down) and a corrector call at
    the midpoint (``interleaved``), which advances the saved sample to
    sigma_down and adds the ancestral noise; the terminal interval is one
    Euler-ancestral step."""

    interleaved: bool = True

    def init_state(self, num_inference_steps):
        ac = self.alphas_cumprod
        return {"sigmas": _f32(self.sigmas(num_inference_steps)),
                "log_sigmas": _f32(np.log(np.sqrt((1 - ac) / ac))),
                "sample": None, "in_correction": False}

    def _interval(self, state, i):
        sig, sig_next = state["sigmas"][i], state["sigmas"][i + 1]
        sigma_up, sigma_down = _ancestral(sig, sig_next)
        sigma_mid = torch.exp(0.5 * (torch.log(sig) + torch.log(sigma_down.clamp(min=1e-10))))
        return sig, sig_next, sigma_up, sigma_down, sigma_mid

    def model_timestep(self, i, ts, state):
        if not state["in_correction"]:
            return float(ts[i])
        sigma_mid = self._interval(state, i)[4]
        log_sigmas = state["log_sigmas"]
        log_sigma = torch.log(sigma_mid.clamp(min=1e-10))
        # piecewise-linear inversion of the ascending log-sigma table
        # (k-diffusion's sigma_to_t)
        low = min(max(int((log_sigma - log_sigmas >= 0).sum()) - 1, 0), len(log_sigmas) - 2)
        lo, hi = log_sigmas[low], log_sigmas[low + 1]
        w = ((lo - log_sigma) / (lo - hi)).clamp(0.0, 1.0)
        return float((1 - w) * low + w * (low + 1))

    def scale_model_input(self, sample, i, state):
        sig, _, _, _, sigma_mid = self._interval(state, i)
        s = sigma_mid if state["in_correction"] else sig
        return sample / torch.sqrt(s**2 + 1)

    def step(self, model_output, i, ts, sample, state, noise=None):
        sig, sig_next, sigma_up, sigma_down, sigma_mid = self._interval(state, i)
        in_corr = state["in_correction"]
        terminal = bool(sig_next <= 0.0)
        if in_corr:
            x0 = self._x0_from_sigma(model_output, sample, sigma_mid)
            d = (sample - x0) / sigma_mid.clamp(min=1e-10)
            out = state["sample"] + d * (sigma_down - sig)
        else:
            x0 = self._x0_from_sigma(model_output, sample, sig)
            d = (sample - x0) / sig
            out = sample + d * ((sigma_down if terminal else sigma_mid) - sig)
        # the ancestral noise applies when the interval completes
        if noise is not None and (in_corr or terminal):
            out = out + sigma_up * noise
        return out, dict(state, sample=state["sample"] if in_corr else sample,
                         in_correction=not in_corr and not terminal)


SCHEDULERS = {
    "DDIM": DDIMScheduler,
    "DDPM": DDPMScheduler,
    "EulerDiscrete": EulerDiscreteScheduler,
    "EulerAncestralDiscrete": EulerAncestralDiscreteScheduler,
    "HeunDiscrete": HeunDiscreteScheduler,
    "DPMSolverMultistep": DPMSolverMultistepScheduler,
    "DPMSolverSinglestep": DPMSolverSinglestepScheduler,
    "DEISMultistep": DEISMultistepScheduler,
    "PNDM": PNDMScheduler,
    "KDPM2AncestralDiscrete": KDPM2AncestralDiscreteScheduler,
}


def get_scheduler(name: str, **kwargs):
    """The scheduler ``name`` (with or without the "Scheduler" suffix),
    configured by ``kwargs``; unknown names and keys raise ``ValueError``."""
    key = name.replace("Scheduler", "")
    if key not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name}; known: {sorted(SCHEDULERS)}")
    cls = SCHEDULERS[key]
    accepted = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kwargs) - accepted)
    if unknown:
        raise ValueError(
            f"{cls.__name__} does not accept {unknown}; accepted config keys: {sorted(accepted)}"
        )
    return cls(**kwargs)
