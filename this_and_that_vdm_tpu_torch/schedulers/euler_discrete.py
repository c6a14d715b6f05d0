"""EulerDiscrete EDM scheduler with Karras sigmas (counterpart of
``schedulers/euler_discrete.py``).

The SVD configuration: v-prediction, continuous timesteps t = 0.25 ln(sigma),
Karras ramp (rho 7) from sigma_max 700 to sigma_min 0.002, "leading" spacing
(init_noise_sigma = sqrt(sigma_max^2 + 1)), s_churn 0 (a pure ODE Euler
step).  The sigma table is host-side numpy; the step is tensor arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SVD_SIGMA_MIN = 0.002
SVD_SIGMA_MAX = 700.0
SVD_RHO = 7.0


@dataclasses.dataclass(frozen=True)
class EulerDiscreteSchedule:
    sigmas: np.ndarray  # [num_steps + 1] float32, final 0
    timesteps: np.ndarray  # [num_steps] float32, 0.25 * ln(sigma)
    init_noise_sigma: float
    num_steps: int

    def scale_model_input(self, sample: torch.Tensor, step_index: int) -> torch.Tensor:
        """EDM c_in: ``x / sqrt(sigma^2 + 1)``."""
        sigma = np.float32(self.sigmas[step_index])
        return sample / float(np.sqrt(sigma * sigma + np.float32(1.0)))

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor) -> torch.Tensor:
        """One Euler step: ``x + (x - D(x)) / sigma * (sigma_next - sigma)``
        with the v-prediction denoiser ``D = c_out * out + c_skip * x``."""
        sigma = torch.tensor(self.sigmas[step_index], dtype=torch.float32)
        sigma_next = torch.tensor(self.sigmas[step_index + 1], dtype=torch.float32)
        x = sample.float()
        out = model_output.float()
        denoised = out * (-sigma / torch.sqrt(sigma * sigma + 1.0)).item() \
            + x / (sigma * sigma + 1.0).item()
        derivative = (x - denoised) / sigma.item()
        return (x + derivative * (sigma_next - sigma).item()).to(sample.dtype)


def karras_sigmas(num_steps: int, sigma_min: float = SVD_SIGMA_MIN,
                  sigma_max: float = SVD_SIGMA_MAX, rho: float = SVD_RHO) -> np.ndarray:
    """Karras et al. (2022) eq. 5 ramp, descending from sigma_max."""
    ramp = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def make_svd_schedule(num_steps: int = 25) -> EulerDiscreteSchedule:
    sig = karras_sigmas(num_steps)
    timesteps = 0.25 * np.log(sig)
    sigmas = np.concatenate([sig, [0.0]]).astype(np.float32)
    return EulerDiscreteSchedule(
        sigmas=sigmas,
        timesteps=timesteps.astype(np.float32),
        init_noise_sigma=float(np.sqrt(np.max(sigmas) ** 2 + 1.0)),
        num_steps=num_steps,
    )
