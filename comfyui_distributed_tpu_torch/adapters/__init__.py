"""The adapter plane: per-request LoRA on the elastic tier.

The port's own copy of comfyui_distributed_tpu/adapters/, the whole-grant
half (the cross-job tier's per-slot application is ROADMAP.md, Queue 1
item 4b):

- ``registry``  the adapter catalog: name → kohya safetensors source
  with a blake2b content-hash identity, which the tile cache key and the
  worker's verification speak;
- ``segmented`` rank-bucketed (down, up) operands for the backbone
  weights an adapter covers, and the whole-grant weight patch
  (`patch_params`, through the merge LoraLoader uses too);
- ``cache``     the host LRU of decoded operands under a byte budget,
  and the scheduler's cold-adapter admission cost.
"""

from .cache import (  # noqa: F401
    AdapterOperandCache,
    adapter_admission_cost,
    get_adapter_cache,
    operands_for_plan,
)
from .registry import (  # noqa: F401
    MAX_ADAPTERS_PER_REQUEST,
    AdapterCatalog,
    AdapterError,
    AdapterSpec,
    adapter_plan_key,
    get_adapter_catalog,
    parse_adapter_specs,
    specs_from_wire,
    specs_to_wire,
)
from .segmented import (  # noqa: F401
    SegmentOperands,
    apply_segment_delta,
    build_operands,
    bundle_target_map,
    compose_operands,
    patch_params,
    rank_bucket_for,
    rank_buckets,
)
