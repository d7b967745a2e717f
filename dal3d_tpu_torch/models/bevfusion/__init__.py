from .bevfusion import BEVFusion
from .centerpoint import CenterHead, CenterTestCfg, center_head_decode, center_head_loss
from .second import SECOND, SECONDFPN
from .segm import BEVSegmentationHead, bev_segmentation_loss, bev_segmentation_miou
from .sparse_encoder import SparseEncoder
from .transfusion import TransFusionHead, TransFusionTestCfg, transfusion_decode
