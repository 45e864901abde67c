"""idle_pct.offline_b32: `idle_pct.offline` read in the cells that report
`serve_img_per_s.b32`, the end-to-end rate it moves there."""

from perfbench import cells

read = cells.module("metrics", "idle_pct.offline").read
UNIT = cells.module("metrics", "idle_pct.offline").UNIT
