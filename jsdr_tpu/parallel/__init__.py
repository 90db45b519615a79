"""Multi-device scaling: device meshes, halo-exchange overlap-save
filtering, and the sharded telemetry pipeline.

The reference is single-process thread-parallel (SURVEY.md section 2.2);
this package supplies the distributed design obligations: DP (streams
across devices), SP (time axis across devices with ring halo exchange of
filter prehistory via ``ppermute``), TP (one large FFT intra-op sharded,
``tp.py``), PP (chain stages pipelined over device groups,
``pipeline.py``), multi-host (``mesh.init_multihost``, exercised by
tests/test_multihost.py), and XLA collectives between devices.
"""

from .mesh import init_multihost, make_mesh  # noqa: F401
from .pipeline import (make_pp_mesh, pipeline_flush, pipeline_init,  # noqa: F401
                       pipelined_telemetry)  # noqa: F401
from .sharded import (sharded_telemetry_step, sharded_spectrum,  # noqa: F401
                      valid_block_samples)  # noqa: F401
from .tp import tp_fft, tp_spectrum  # noqa: F401
