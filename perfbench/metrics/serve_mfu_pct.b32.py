"""serve_mfu_pct.b32: `serve_mfu_pct` read in the cells that report
`serve_img_per_s.b32`, the end-to-end rate it moves there."""

from perfbench import cells

read = cells.module("metrics", "serve_mfu_pct").read
UNIT = cells.module("metrics", "serve_mfu_pct").UNIT
