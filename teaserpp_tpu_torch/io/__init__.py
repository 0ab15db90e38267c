"""Point-cloud I/O (PLY read/write; reference ply_io.{h,cc} parity)."""

from teaserpp_tpu_torch.io.ply import PLYReader, PLYWriter, read_ply, write_ply

__all__ = ["PLYReader", "PLYWriter", "read_ply", "write_ply"]
