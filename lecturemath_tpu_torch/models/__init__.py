from .fcn_lecturenet import FCNLectureNet, FCNConfig
from .convert import state_dict_from_flax
