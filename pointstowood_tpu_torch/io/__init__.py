from pointstowood_tpu_torch.io.las import read_las, write_las
from pointstowood_tpu_torch.io.loader import load_file, save_file
from pointstowood_tpu_torch.io.pcd import read_pcd, write_pcd
from pointstowood_tpu_torch.io.ply import (
    extra_columns,
    n_rows,
    read_ply,
    select_rows,
    write_ply,
)

__all__ = [
    "load_file",
    "save_file",
    "n_rows",
    "select_rows",
    "extra_columns",
    "read_ply",
    "write_ply",
    "read_pcd",
    "write_pcd",
    "read_las",
    "write_las",
]
