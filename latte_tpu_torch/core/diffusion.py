"""Gaussian diffusion engine (port of ``latte_tpu/core/diffusion.py``).

Schedule tables are fp64 numpy, computed once; each step gathers its
coefficients in fp32 on the tensor's device, as the JAX engine does.
Respacing is folded into the engine: loops run over respaced indices and
:meth:`GaussianDiffusion.map_t` maps them to the model's timesteps.

The model contract: ``model_fn(x, t, **model_kwargs)`` with ``x`` of shape
(B, F, C, H, W), returning (B, F, 2C, H, W) when the variance is learned.
Besides the reverse steps it carries the classifier-guidance hooks
(``cond_fn(x, t, **model_kwargs)``, the classifier's gradient), the DDIM
reverse (encoding) step, the training losses of the four loss types and the
bits-per-dim evaluation of the full variational bound.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from latte_tpu_torch.core.diffusion_utils import (
    discretized_gaussian_log_likelihood,
    mean_flat,
    normal_kl,
)
from latte_tpu_torch.core.schedules import get_named_beta_schedule, space_timesteps

ModelFn = Callable[..., torch.Tensor]


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


class GaussianDiffusion:
    """The diffusion engine over fp64 ``betas`` (possibly respaced, with
    ``timestep_map`` from engine index to original model timestep)."""

    def __init__(
        self,
        *,
        betas: np.ndarray,
        model_mean_type: ModelMeanType = ModelMeanType.EPSILON,
        model_var_type: ModelVarType = ModelVarType.LEARNED_RANGE,
        loss_type: LossType = LossType.MSE,
        timestep_map: Optional[np.ndarray] = None,
        original_num_steps: Optional[int] = None,
    ):
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((0 < betas).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        self.betas = betas
        self.num_timesteps = int(betas.shape[0])
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        self.timestep_map = (
            None if timestep_map is None else np.asarray(timestep_map, dtype=np.int64)
        )
        self.original_num_steps = original_num_steps or self.num_timesteps

        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas, axis=0)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.alphas_cumprod_next = np.append(self.alphas_cumprod[1:], 0.0)
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.log_one_minus_alphas_cumprod = np.log(1.0 - self.alphas_cumprod)
        self._one_minus_alphas_cumprod = 1.0 - self.alphas_cumprod
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1.0)
        self.log_betas = np.log(betas)
        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        )
        # the posterior variance is 0 at t=0: borrow the t=1 entry (or, for a
        # one-step schedule, the clipped t=0 value) before taking the log
        pv1 = (
            self.posterior_variance[1]
            if len(self.posterior_variance) > 1
            else max(self.posterior_variance[0], 1e-20)
        )
        self.posterior_log_variance_clipped = np.log(
            np.append(pv1, self.posterior_variance[1:])
        )
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        )
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - self.alphas_cumprod)
        )
        self._recip_posterior_mean_coef1 = 1.0 / self.posterior_mean_coef1
        self._posterior_mean_coef_ratio = self.posterior_mean_coef2 / self.posterior_mean_coef1
        self._fixed_large_variance = np.append(pv1, betas[1:])
        self._fixed_large_log_variance = np.log(self._fixed_large_variance)
        self._device_tables: Dict[Any, torch.Tensor] = {}

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        key = (name, device)
        if key not in self._device_tables:
            arr = getattr(self, name)
            dtype = torch.int64 if name == "timestep_map" else torch.float32
            self._device_tables[key] = torch.as_tensor(arr, dtype=dtype, device=device)
        return self._device_tables[key]

    def tables(self) -> Dict[str, torch.Tensor]:
        """Every per-timestep table as the CPU tensor :meth:`_table` would
        place on a device (int64 ``timestep_map``, the rest fp32)."""
        return {
            name: torch.as_tensor(arr, dtype=torch.int64 if name == "timestep_map" else torch.float32)
            for name, arr in vars(self).items() if isinstance(arr, np.ndarray)
        }

    def place_tables(self, tables: Dict[str, torch.Tensor], device: torch.device) -> None:
        """Use ``tables`` (those of :meth:`tables`, already on ``device``) for
        ``device``: an exported step takes them as its constants."""
        self._device_tables.update({(name, device): t for name, t in tables.items()})

    def _gather(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """fp32 per-timestep coefficients, shaped to broadcast over ``ndim`` axes."""
        # index_select, not [t]: a tensor index has no fake-tensor rule for
        # CUDA on a host without it (serve.aot traces for the card there)
        out = torch.index_select(self._table(name, t.device), 0, t)
        return out.reshape(out.shape + (1,) * (ndim - 1))

    def map_t(self, t: torch.Tensor) -> torch.Tensor:
        """Map engine timestep indices to original model timesteps."""
        if self.timestep_map is None:
            return t
        return torch.index_select(self._table("timestep_map", t.device), 0, t)

    def q_mean_variance(self, x_start, t):
        """q(x_t | x_0): its mean, variance and log-variance."""
        n = x_start.dim()
        return (
            self._gather("sqrt_alphas_cumprod", t, n) * x_start,
            self._gather("_one_minus_alphas_cumprod", t, n),
            self._gather("log_one_minus_alphas_cumprod", t, n),
        )

    def q_sample(self, x_start, t, noise):
        """Diffuse x_0 to x_t given noise ~ N(0, I)."""
        return (
            self._gather("sqrt_alphas_cumprod", t, x_start.dim()) * x_start
            + self._gather("sqrt_one_minus_alphas_cumprod", t, x_start.dim()) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        n = x_t.dim()
        mean = (
            self._gather("posterior_mean_coef1", t, n) * x_start
            + self._gather("posterior_mean_coef2", t, n) * x_t
        )
        return (
            mean,
            self._gather("posterior_variance", t, n),
            self._gather("posterior_log_variance_clipped", t, n),
        )

    def _predict_xstart_from_eps(self, x_t, t, eps):
        n = x_t.dim()
        return (
            self._gather("sqrt_recip_alphas_cumprod", t, n) * x_t
            - self._gather("sqrt_recipm1_alphas_cumprod", t, n) * eps
        )

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        n = x_t.dim()
        return (
            self._gather("_recip_posterior_mean_coef1", t, n) * xprev
            - self._gather("_posterior_mean_coef_ratio", t, n) * x_t
        )

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        n = x_t.dim()
        return (
            self._gather("sqrt_recip_alphas_cumprod", t, n) * x_t - pred_xstart
        ) / self._gather("sqrt_recipm1_alphas_cumprod", t, n)

    def p_mean_variance(
        self,
        model_fn: ModelFn,
        x,
        t,
        clip_denoised: bool = True,
        denoised_fn: Optional[Callable] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
        model_output: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """p(x_{t-1} | x_t) mean and variance, and the x_0 prediction."""
        if model_output is None:
            model_output = model_fn(x, self.map_t(t), **(model_kwargs or {}))
        n = x.dim()
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, var_values = torch.split(
                model_output, [x.shape[2], model_output.shape[2] - x.shape[2]], dim=2
            )
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = var_values
            else:
                min_log = self._gather("posterior_log_variance_clipped", t, n)
                max_log = self._gather("log_betas", t, n)
                frac = (var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = self._gather("_fixed_large_variance", t, n)
            model_log_variance = self._gather("_fixed_large_log_variance", t, n)
        else:
            model_variance = self._gather("posterior_variance", t, n)
            model_log_variance = self._gather("posterior_log_variance_clipped", t, n)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            return x0.clamp(-1.0, 1.0) if clip_denoised else x0

        if self.model_mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
        elif self.model_mean_type == ModelMeanType.EPSILON:
            pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
        else:
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """The mean shifted by the variance times the classifier gradient
        ``cond_fn(x, t, **model_kwargs)`` (t the model's timesteps)."""
        gradient = cond_fn(x, self.map_t(t), **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None):
        """``p_mean_var`` with the score conditioned on the classifier
        gradient (DDIM's guidance): eps - sqrt(1 - alpha_bar)·gradient, and
        x_0 and the mean predicted from it."""
        alpha_bar = self._gather("alphas_cumprod", t, x.dim())
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, self.map_t(t), **(model_kwargs or {}))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    def p_sample(
        self, model_fn: ModelFn, x, t, noise, clip_denoised: bool = True,
        denoised_fn=None, cond_fn=None, model_kwargs=None,
    ):
        """One DDPM ancestral step; ``noise`` is caller-supplied N(0, I)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t, model_kwargs)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(
        self, model_fn: ModelFn, x, t, noise, clip_denoised: bool = True,
        denoised_fn=None, cond_fn=None, model_kwargs=None, eta: float = 0.0,
    ):
        """One DDIM step (deterministic at eta=0)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        n = x.dim()
        alpha_bar = self._gather("alphas_cumprod", t, n)
        alpha_bar_prev = self._gather("alphas_cumprod_prev", t, n)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma**2) * eps
        )
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (n - 1))
        return {"sample": mean_pred + nonzero * sigma * noise, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(
        self, model_fn: ModelFn, x, t, clip_denoised: bool = True, denoised_fn=None,
        model_kwargs=None, eta: float = 0.0,
    ):
        """One step of the reverse (encoding) ODE, x_t to x_{t+1}; ``eta``
        must be 0 (else the JAX engine's ``AssertionError``)."""
        if eta != 0.0:
            raise AssertionError("ReverseODE only for deterministic path")
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = self._gather("alphas_cumprod_next", t, x.dim())
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    # ------------------------------------------------------------------
    # Variational bound and training losses
    # ------------------------------------------------------------------
    def _vb_terms_bpd(
        self, model_fn: ModelFn, x_start, x_t, t, clip_denoised: bool = True,
        model_kwargs=None, model_output: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """One term of the variational bound in bits per dim: the KL of the
        posterior against the model's p(x_{t-1} | x_t), or at t = 0 the
        decoder's negative log-likelihood."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(
            model_fn, x_t, t, clip_denoised=clip_denoised, model_kwargs=model_kwargs,
            model_output=model_output,
        )
        kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"]))
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
        )
        decoder_nll = mean_flat(decoder_nll) / np.log(2.0)
        output = torch.where(t == 0, decoder_nll, kl / np.log(2.0))
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_losses(
        self, model_fn: ModelFn, x_start, t, model_kwargs=None, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Per-example training losses (shape [B]) for ``noise`` (else drawn
        from ``generator``), in the JAX engine's argument order
        (``model_kwargs`` fourth, ``noise`` fifth, ``generator`` in ``rng``'s
        place). KL types: ``loss`` is the VB term, the model's mean not detached, times ``num_timesteps`` for RESCALED_KL. MSE
        types: ``mse`` and, with a learned variance, the hybrid ``mse + vb``,
        where the VB term sees a detached mean so only the variance head
        learns from it, times ``num_timesteps / 1000`` for RESCALED_MSE
        (``diffusion.py:426-488`` of the JAX engine)."""
        if noise is None:
            if generator is None:
                raise ValueError("training_losses needs `noise` or `generator`")
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, torch.Tensor] = {}
        if self.loss_type.is_vb():
            terms["loss"] = self._vb_terms_bpd(
                model_fn, x_start, x_t, t, clip_denoised=False, model_kwargs=model_kwargs
            )["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model_fn(x_t, self.map_t(t), **(model_kwargs or {}))
        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            c = x_t.shape[2]
            mean_out, var_values = torch.split(model_output, [c, model_output.shape[2] - c], dim=2)
            frozen_out = torch.cat([mean_out.detach(), var_values], dim=2)
            terms["vb"] = self._vb_terms_bpd(
                model_fn, x_start, x_t, t, clip_denoised=False, model_output=frozen_out
            )["output"]
            if self.loss_type == LossType.RESCALED_MSE:
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
            model_output = mean_out

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.model_mean_type == ModelMeanType.START_X:
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    # ------------------------------------------------------------------
    # Bits-per-dim evaluation
    # ------------------------------------------------------------------
    def _prior_bpd(self, x_start):
        """KL of q(x_T | x_0) against N(0, I), in bits per dim, (B,)."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.int64, device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        zero = torch.zeros((), dtype=x_start.dtype, device=x_start.device)
        return mean_flat(normal_kl(qt_mean, qt_log_variance, zero, zero)) / np.log(2.0)

    def calc_bpd_loop(
        self, model_fn: ModelFn, x_start, generator: Optional[torch.Generator] = None,
        noise_schedule: Optional[torch.Tensor] = None, clip_denoised: bool = True, model_kwargs=None,
    ) -> Dict[str, torch.Tensor]:
        """The full variational bound in bits per dim, over t = T - 1 down
        to 0. Step t's noise is ``noise_schedule[t]`` when given, else drawn
        from ``generator``. ``vb``, ``xstart_mse`` and ``mse`` are (B, T),
        their columns in that order (column 0 is t = T - 1), as the JAX
        scan stacks them; ``total_bpd`` is the vb terms' sum plus
        ``prior_bpd``."""
        if noise_schedule is None and generator is None:
            raise ValueError("calc_bpd_loop needs `noise_schedule` or `generator`")
        batch = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for t_scalar in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((batch,), t_scalar, dtype=torch.int64, device=x_start.device)
            if noise_schedule is not None:
                noise = noise_schedule[t_scalar].to(x_start.device, x_start.dtype)
            else:
                noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                                    dtype=x_start.dtype)
            x_t = self.q_sample(x_start, t, noise)
            out = self._vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised, model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - noise) ** 2))
        vb_t = torch.stack(vb, dim=1)
        prior_bpd = self._prior_bpd(x_start)
        return {
            "total_bpd": vb_t.sum(dim=1) + prior_bpd,
            "prior_bpd": prior_bpd,
            "vb": vb_t,
            "xstart_mse": torch.stack(xstart_mse, dim=1),
            "mse": torch.stack(mse, dim=1),
        }


def create_diffusion(
    timestep_respacing: Union[str, Sequence[int], None],
    noise_schedule: str = "linear",
    use_kl: bool = False,
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
) -> GaussianDiffusion:
    """The reference defaults: 1000 linear steps, epsilon prediction,
    LEARNED_RANGE variance, MSE loss (``use_kl``: RESCALED_KL, else
    ``rescale_learned_sigmas``: RESCALED_MSE). ``"ddim50"`` or ``"250"``
    respaces the process."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)

    # respace: recompute betas over the retained subset of alphas_cumprod
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    timestep_map, new_betas = [], []
    last = 1.0
    for i, ab in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1 - ab / last)
            last = ab
            timestep_map.append(i)

    return GaussianDiffusion(
        betas=np.array(new_betas, dtype=np.float64),
        model_mean_type=ModelMeanType.START_X if predict_xstart else ModelMeanType.EPSILON,
        model_var_type=(
            ModelVarType.LEARNED_RANGE
            if learn_sigma
            else (ModelVarType.FIXED_SMALL if sigma_small else ModelVarType.FIXED_LARGE)
        ),
        loss_type=loss_type,
        timestep_map=(
            np.array(timestep_map, dtype=np.int64) if len(timestep_map) != diffusion_steps else None
        ),
        original_num_steps=diffusion_steps,
    )
