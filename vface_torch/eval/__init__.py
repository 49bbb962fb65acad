"""The port's evaluation harness (``vface_tpu/eval``): FID, ID retrieval
(top-1 / top-5 / cosine), pose L2 (Hopenet), expression L2 (Deep3DFaceRecon
coefficients), LPIPS, the temporal metrics and the BFM renderer;
:func:`vface_torch.eval.harness.evaluate_all` runs the four image metrics."""

from vface_torch.eval.expression import FaceReconNet, expression_l2, face_coeffs
from vface_torch.eval.fid import InceptionV3Pool3, compute_fid, frechet_distance
from vface_torch.eval.id_retrieval import embed_faces, id_retrieval
from vface_torch.eval.lpips import LPIPS, make_lpips_fn
from vface_torch.eval.pose import Hopenet, head_pose, pose_l2

__all__ = [
    "FaceReconNet",
    "expression_l2",
    "face_coeffs",
    "InceptionV3Pool3",
    "compute_fid",
    "frechet_distance",
    "embed_faces",
    "id_retrieval",
    "LPIPS",
    "make_lpips_fn",
    "Hopenet",
    "head_pose",
    "pose_l2",
]
