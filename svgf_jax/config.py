"""Configuration dataclasses — the full tunable surface of the reference.

Mirrors the reference's two mutable parameter structs:
  - tracingParameters (reference src/Tracing.h:17-38)
  - SVGF knobs on `application` (reference src/App.h:106-114, GUI ranges GUI.cpp:981-1002)
plus resolution / debug tap / mesh configuration which the reference keeps in
window state and compile-time switches.

Everything is a frozen dataclass so configs are hashable and can be closed over
by jit without retracing surprises.
"""

from __future__ import annotations

import dataclasses
import enum
import json


class SamplingMode(enum.IntEnum):
    """Reference src/Tracing.h:9-12 (BSDF / LIGHT / BOTH / MIS)."""

    BSDF = 0
    LIGHT = 1
    BOTH = 2
    MIS = 3


class DebugOutput(enum.IntEnum):
    """Debug taps into the pipeline — reference src/App.h:92-105 (11 modes).

    Selects which intermediate buffer `render_frame` returns as its `image`
    output (all intermediates are also available in FrameOutputs).
    """

    FINAL = 0
    RAW = 1                # raster + trace only (no filtering)
    NORMAL = 2
    MOTION = 3
    POSITION = 4
    BARYCENTRIC = 5
    TEMPORAL = 6           # after temporal accumulation
    ATROUS = 7             # after wavelet filtering (pre-TAA)
    MOMENTS = 8
    VARIANCE = 9
    DEPTH = 10


@dataclasses.dataclass(frozen=True)
class TracingConfig:
    """Path-tracing parameters. Defaults per reference src/Tracing.h:28-38."""

    batch: int = 1                 # samples per pixel per frame
    bounces: int = 3
    current_camera: int = 0
    clamp: float = 10.0            # radiance clamp
    sampling_mode: SamplingMode = SamplingMode.MIS


@dataclasses.dataclass(frozen=True)
class SVGFConfig:
    """SVGF filter parameters. Defaults per reference src/App.h:109-114."""

    spatial_filter_steps: int = 3      # a-trous iterations (GUI 0-10; paper uses 5)
    depth_threshold: float = 0.8       # temporal reprojection |dz| rejection
    normal_threshold: float = 0.9      # temporal reprojection dot(n,n') rejection
    history_length: int = 24           # EMA history cap ("HistoryBaseLength")
    phi_colour: float = 10.0
    phi_normal: float = 128.0
    enable_taa: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Multi-chip configuration (new capability; no reference equivalent).

    The frame is sharded over image rows across `tiles_y` devices and
    (optionally) over columns across `tiles_x` devices.
    """

    tiles_y: int = 1
    tiles_x: int = 1
    axis_y: str = "ty"
    axis_x: str = "tx"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 800
    height: int = 600
    tracing: TracingConfig = dataclasses.field(default_factory=TracingConfig)
    svgf: SVGFConfig = dataclasses.field(default_factory=SVGFConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    debug_output: DebugOutput = DebugOutput.FINAL
    # Materialize every intermediate stage in FrameOutputs (radiance,
    # temporal, moments, a-trous, gbuffer). Keeping them all live to the end
    # of the frame program costs ~40% wall-clock at 1080p (XLA live-range /
    # copy pressure around the chunked trace), so perf paths turn this off —
    # the reference likewise only renders the buffers its debug mode needs
    # (App.cu:539-690). debug_output != FINAL implies taps regardless.
    keep_taps: bool = True
    # Storage dtype for temporal state buffers. The reference stores fp16
    # (App.cu:763-773); "float32" for tests.
    state_dtype: str = "float16"
    # Use the G-buffer for the primary hit ("hybrid" trick, Common.cuh:1542-1568).
    hybrid_primary: bool = True
    # Deterministic RNG seed (replaces the reference's wall-clock Time seed).
    seed: int = 0
    # Trace-stage wavefront chunking: number of sequential ray chunks per
    # frame (peak device memory of the shading stage scales as 1/chunks);
    # 1 = single wavefront.
    trace_chunks: int = 1
    # Ray load balancing on sharded meshes (SURVEY §2.7): one all_to_all
    # re-deals rows round-robin before the trace so every shard works a
    # uniform sample of the image, and one deals radiance back. Measured
    # row-band live-lane imbalance on BaseScene is 98% at bounce 0
    # (scripts/measure_balance.py); per-pixel results are bitwise unchanged.
    trace_balance: bool = True

    # ---- (de)serialization: the reference has no config files; we add JSON. ----
    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
            if isinstance(o, enum.IntEnum):
                return int(o)
            return o

        return json.dumps(enc(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RenderConfig":
        d = json.loads(text)
        tracing = d.pop("tracing", {})
        svgf = d.pop("svgf", {})
        mesh = d.pop("mesh", {})
        if "sampling_mode" in tracing:
            tracing["sampling_mode"] = SamplingMode(tracing["sampling_mode"])
        if "debug_output" in d:
            d["debug_output"] = DebugOutput(d["debug_output"])
        return RenderConfig(
            tracing=TracingConfig(**tracing),
            svgf=SVGFConfig(**svgf),
            mesh=MeshConfig(**mesh),
            **d,
        )
