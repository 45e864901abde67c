"""launch_idle_pct.b32: `launch_idle_pct` read in the cells that report
`serve_img_per_s.b32`, the end-to-end rate it moves there."""

from perfbench import cells

read = cells.module("metrics", "launch_idle_pct").read
UNIT = cells.module("metrics", "launch_idle_pct").UNIT
