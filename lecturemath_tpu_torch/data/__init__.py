from .cc import CC, extract_ccs, merge_ccs
from .space_time import SpaceTimeStruct
