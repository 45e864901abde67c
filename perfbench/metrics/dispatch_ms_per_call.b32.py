"""dispatch_ms_per_call.b32: `dispatch_ms_per_call` read in the cells that report
`serve_img_per_s.b32`, the end-to-end rate it moves there."""

from perfbench import cells

read = cells.module("metrics", "dispatch_ms_per_call").read
UNIT = cells.module("metrics", "dispatch_ms_per_call").UNIT
