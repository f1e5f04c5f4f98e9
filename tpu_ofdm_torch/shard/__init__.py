"""Mesh construction, halo exchange, and sharded pipelines (counterpart of
tpu_ofdm/shard/): a (channel x time) mesh of shards, each on a torch
device (a device may repeat), with a local or a torch.distributed
communicator.
"""

from tpu_ofdm_torch.shard.halo import (  # noqa: F401
    extend_with_left_halo,
    halo_from_left,
    halo_from_right,
)
from tpu_ofdm_torch.shard.mesh import (  # noqa: F401
    CHANNEL_AXIS,
    TIME_AXIS,
    balanced_factors,
    make_mesh,
    single_device_mesh,
)
from tpu_ofdm_torch.shard.rx import (  # noqa: F401
    collect_sharded_frames,
    collect_sharded_stream_frames,
    sharded_rx_capture_fn,
    sharded_rx_stream_block,
)
from tpu_ofdm_torch.shard.distributed import (  # noqa: F401
    LinkCounters,
    MeshHeartbeat,
    all_gather_spectrum,
    barrier,
    broadcast_control,
    counters_from_rx,
    global_mesh,
    initialize,
    metrics_from_counters,
    psum_tree,
    shard_capture,
)
from tpu_ofdm_torch.shard.wideband import (  # noqa: F401
    mesh_psd_step_fn,
    sharded_wideband_capture_fn,
    sharded_wideband_stream_block,
)
