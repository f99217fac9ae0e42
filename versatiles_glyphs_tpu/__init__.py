"""versatiles_glyphs_tpu — differentiable SDF glyph framework on JAX.

A from-scratch JAX re-design of the capabilities of
`versatiles-org/versatiles-glyphs-rs`: TrueType/OpenType fonts →
maplibre/mapbox signed-distance-field glyph atlases (one .pbf per
256-codepoint block + index.json + font_families.json, to a directory
or streamed tar), plus what the Rust reference doesn't have — a
differentiable, batched, mesh-shardable SDF renderer for font fitting
on GPUs.

Layers (bottom-up; compare SURVEY.md §1):

- ``ops``      — geometry flattening (host f64), SDF evaluation
                 (exact NumPy golden / plain JAX reference / Hopper
                 tile kernel through Pallas and Triton)
- ``render``   — per-glyph metrics (integer parity), batch packing,
                 backend driver
- ``font``     — ingestion, metadata, name parsing, blocks, manager
- ``proto``    — mapbox glyphs.proto wire codec (+ C++ fast path)
- ``writer``   — directory / ustar tar / dummy writers
- ``parallel`` — mesh sharding of block batches, multi-host layout
- ``models``   — differentiable glyph model + font fitting loop
- ``cli``      — recurse / merge / debug commands
"""

__version__ = "0.4.0"

from .constants import BUFFER, CUTOFF, GLYPH_SIZE, SDF_RADIUS  # noqa: F401
