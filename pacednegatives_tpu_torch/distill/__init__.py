from pacednegatives_tpu_torch.distill.teacher import TeacherScores, score_teachers
from pacednegatives_tpu_torch.distill.miner import EnsembleMiner
from pacednegatives_tpu_torch.distill.loader import TeacherBatcher
from pacednegatives_tpu_torch.distill.train import make_distill_step

__all__ = [
    "TeacherScores",
    "score_teachers",
    "EnsembleMiner",
    "TeacherBatcher",
    "make_distill_step",
]
