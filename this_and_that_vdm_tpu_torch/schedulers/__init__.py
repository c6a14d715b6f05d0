from .euler_discrete import EulerDiscreteSchedule, karras_sigmas, make_svd_schedule

__all__ = ["EulerDiscreteSchedule", "karras_sigmas", "make_svd_schedule"]
