"""The persistent store of strategy set-ups (counterpart of ``programs/``).

``programs.keys``  -- the key grammar of every persistent cache, the JAX
package's character for character.
``programs.store`` -- the store: set-up entries under
``artifacts/programs_torch/``, a flock'd index, eviction of bad entries and
a rebuild in their place.
"""

from distributed_sddmm_tpu_torch.programs.keys import (  # noqa: F401
    dist_segment,
    parse_bench_key,
    parse_dist_segment,
    parse_key,
    parse_plan_key,
    parse_serve_key,
    plan_program_key,
    safe_stem,
    serve_program_key,
    sig_for_args,
)
from distributed_sddmm_tpu_torch.programs.store import (  # noqa: F401
    DEFAULT_ROOT,
    SCHEMA_VERSION,
    ProgramStore,
    SetupConfig,
    active,
    bind_strategy,
    build_bound,
    chained_program,
    disable,
    enable,
    matrix_content_key,
    strategy_config_tag,
)
