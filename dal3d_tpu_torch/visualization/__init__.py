"""Offline visualisation of lidar frames and detections (port of
``dal3d_tpu/visualization``): host numpy, matplotlib on Agg imported only
when a figure is drawn."""
from .simplevis import bev_plot, save_bev
from .vis3d import (
    boxes_to_corners_3d, detection_gallery, draw_boxes_on_image,
    plot_3d_scene, plot_heatmap, plot_range_image, project_boxes_to_image,
    range_image, save_scene,
)
