from .euler_discrete import (EulerDiscreteSchedule, karras_sigmas, make_svd_schedule,
                             table_scale_model_input, table_step)

__all__ = ["EulerDiscreteSchedule", "karras_sigmas", "make_svd_schedule",
           "table_scale_model_input", "table_step"]
