"""h2d_wait_ms_per_img.b32: `h2d_wait_ms_per_img` read in the cells that report
`serve_img_per_s.b32`, the end-to-end rate it moves there."""

from perfbench import cells

read = cells.module("metrics", "h2d_wait_ms_per_img").read
UNIT = cells.module("metrics", "h2d_wait_ms_per_img").UNIT
