from .coder import (ErasureCoder, NumpyCoder, TorchCoder, get_coder,
                    register_coder)
from .ec_volume import EcShard, EcVolume, rebuild_ecx_file
from .geometry import (DEFAULT, MAX_TOTAL_SHARDS, Geometry, GeometryPolicy,
                       parse_geometry, to_ext)
from .locate import Interval, locate_data
from .pipeline import stream_encode, stream_encode_many, stream_rebuild
from .striping import (find_dat_file_size, iterate_ecj_file,
                       iterate_ecx_file, read_marker_geometry,
                       rebuild_ec_files, write_dat_file, write_ec_files,
                       write_idx_file_from_ec_index,
                       write_sorted_ecx_from_idx)

__all__ = [
    "ErasureCoder", "NumpyCoder", "TorchCoder", "get_coder",
    "register_coder", "EcShard", "EcVolume", "rebuild_ecx_file",
    "DEFAULT", "MAX_TOTAL_SHARDS", "Geometry", "GeometryPolicy",
    "parse_geometry", "to_ext",
    "Interval", "locate_data", "stream_encode", "stream_encode_many",
    "stream_rebuild",
    "find_dat_file_size", "iterate_ecj_file", "iterate_ecx_file",
    "read_marker_geometry", "rebuild_ec_files", "write_dat_file",
    "write_ec_files", "write_idx_file_from_ec_index",
    "write_sorted_ecx_from_idx",
]
