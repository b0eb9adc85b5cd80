from repro_torch.envcache.snapshot import (  # noqa: F401
    EnvCache, snapshot_dir, diff_snapshots, job_cache_key)
