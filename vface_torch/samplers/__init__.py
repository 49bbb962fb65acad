"""The samplers: DDIM, DDIM inversion, the VFace hooked sampler, PLMS and guided DDIM."""
from vface_torch.samplers.ddim import ddim_sample, ddim_sample_train, ddim_step
from vface_torch.samplers.guided import ddim_sample_guided
from vface_torch.samplers.inversion import ddim_invert
from vface_torch.samplers.plms import plms_sample
from vface_torch.samplers.vface import vface_sample

__all__ = [
    "ddim_sample",
    "ddim_sample_train",
    "ddim_step",
    "ddim_sample_guided",
    "ddim_invert",
    "plms_sample",
    "vface_sample",
]
