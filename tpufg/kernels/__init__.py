from tpufg.kernels.convert import frames_to_planar, planar_to_frames
from tpufg.kernels.lanczos import lanczos_scale_packed, lanczos_scale_planar
from tpufg.kernels.motion import motion_search_sites
from tpufg.kernels.motion_xla import motion_search_xla
from tpufg.kernels.resize import box_downsample2
from tpufg.kernels.warp_matmul import warp_blend_matmul
