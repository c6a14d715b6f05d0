"""EulerDiscrete EDM scheduler with Karras sigmas (counterpart of
``schedulers/euler_discrete.py``).

The SVD configuration: v-prediction, continuous timesteps t = 0.25 ln(sigma),
Karras ramp (rho 7) from sigma_max 700 to sigma_min 0.002, "leading" spacing
(init_noise_sigma = sqrt(sigma_max^2 + 1)), s_churn 0 (a pure ODE Euler
step).  The sigma table is host-side numpy; the step is tensor arithmetic.

``step_table`` turns the schedule into a ``[num_steps, 6]`` fp32 table of
the scalars each step reads (columns ``T`` .. ``DT``), and
``table_scale_model_input`` / ``table_step`` do the step's arithmetic from a
row of it on the device: the denoise loop indexes the row instead of
entering each scalar from the host, so one step can be captured as a CUDA
graph and replayed with the next row (``pipelines/svd.py``).  They divide
where the JAX scheduler divides (a CUDA tensor divisor is a true division;
a host scalar divisor would become a multiply by its reciprocal), so the
table step equals ``step`` bit for bit on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SVD_SIGMA_MIN = 0.002
SVD_SIGMA_MAX = 700.0
SVD_RHO = 7.0

# columns of ``step_table``: the timestep, the divisor of c_in
# (sqrt(sigma^2 + 1)), c_out (-sigma / sqrt(sigma^2 + 1)), the divisor of
# c_skip (sigma^2 + 1), sigma, and sigma_next - sigma
T, IN_DIV, C_OUT, SKIP_DIV, SIGMA, DT = range(6)


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

    def step_table(self) -> np.ndarray:
        """``[num_steps, 6]`` fp32: row ``i`` holds step ``i``'s scalars
        (columns ``T`` .. ``DT``), each computed in fp32 as ``step`` does."""
        s, s_next = self.sigmas[:-1], self.sigmas[1:]
        ss1 = s * s + np.float32(1.0)
        root = np.sqrt(ss1)
        return np.stack([self.timesteps, root, -s / root, ss1, s, s_next - s],
                        axis=1).astype(np.float32)


def table_scale_model_input(sample: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``scale_model_input`` from a row of ``step_table`` (a tensor on the
    sample's device)."""
    return sample / row[IN_DIV]


def table_step(model_output: torch.Tensor, row: torch.Tensor,
               sample: torch.Tensor) -> torch.Tensor:
    """``step`` from a row of ``step_table`` on the sample's device."""
    x = sample.float()
    denoised = model_output.float() * row[C_OUT] + x / row[SKIP_DIV]
    derivative = (x - denoised) / row[SIGMA]
    return (x + derivative * row[DT]).to(sample.dtype)


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
