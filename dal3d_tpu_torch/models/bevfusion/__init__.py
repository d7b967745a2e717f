from .bevfusion import BEVFusion
from .second import SECOND, SECONDFPN
from .sparse_encoder import SparseEncoder
from .transfusion import TransFusionHead, TransFusionTestCfg, transfusion_decode
