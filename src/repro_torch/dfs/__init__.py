from repro_torch.dfs.hdfs import HdfsCluster  # noqa: F401
from repro_torch.dfs.striped import (StripedWriter, StripedReader,  # noqa: F401
                                     StripeMissingError, shared_io_pool)
from repro_torch.dfs.fuse import HdfsFuseMount  # noqa: F401
