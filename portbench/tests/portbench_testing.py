"""What the benchmark's tests share: a small CPU scale and the cells."""

SF = 0.01
TILE_ROWS = 1 << 14  # 4 lineitem tiles at SF 0.01
CELLS = ["sf10-q1-q6", "sf10-q3-q12", "sf1-q1-q6", "sf1-q3-q12"]
KINDS = ["q1", "q6", "q3", "q12"]
