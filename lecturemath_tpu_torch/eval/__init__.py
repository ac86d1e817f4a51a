from .annotation import (KeyframeAnnotation, UniqueCCGroup, KeyframePortion,
                         VideoObject)
from .aligner import translation_alignment
from .evaluator import Evaluator, EvalParams
