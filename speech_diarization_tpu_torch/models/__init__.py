"""The port's model zoo: the JAX package's nets as ``nn.Module`` s whose
``state_dict`` keys are the checkpoints' names, and the speaker-encoder
registry."""
from .layers import batch_norm_apply, conv1d_torch
from .vad import VadNet, VadModel, energy_vad_probs
from .ecapa import EcapaTdnn, EcapaModel
from .eres2netv2 import ERes2NetV2, ERes2NetV2Model
from .campp import CamPlusPlus, CamPlusPlusModel
from .gtcrn import GTCRN
from .zipenhancer import ZipEnhancerModel
from .demix import DialogDemixer
from .demucs_ref import HTDemucsRef
from .zipenhancer_ref import ZipEnhancerRef
from .registry import make_encoder, make_encoder_model, BACKENDS

__all__ = [
    "conv1d_torch",
    "batch_norm_apply",
    "VadNet",
    "VadModel",
    "energy_vad_probs",
    "EcapaTdnn",
    "EcapaModel",
    "ERes2NetV2",
    "ERes2NetV2Model",
    "CamPlusPlus",
    "CamPlusPlusModel",
    "GTCRN",
    "ZipEnhancerModel",
    "DialogDemixer",
    "HTDemucsRef",
    "ZipEnhancerRef",
    "make_encoder",
    "make_encoder_model",
    "BACKENDS",
]
