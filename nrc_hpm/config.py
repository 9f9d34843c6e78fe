"""Configuration dataclasses for the NRC-HPM renderer.

Mirrors the reference's ``AppConfig`` (reference: src/AppConfig.cpp:154-205):
the same 17 experiment parameters, the same six scene presets
(src/AppConfig.cpp:96-149), and the same ``GetName()`` output-directory
naming scheme — rebuilt as plain dataclasses plus mesh/sharding fields that
the single-GPU reference never had.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """NN input-encoding selection.

    Mirrors AppConfig::NNEncodingConfig (reference: src/AppConfig.cpp:11-87).
    pos_id: 0=HashGrid(16 levels, 2 feats, 2^19 table, base 16, scale 2.0),
            1=Identity, 2=TriangleWave(12), 3=Frequency(12).
    dir_id: 0=OneBlob(4 bins), 1=Identity, 2=TriangleWave(4).
    """

    pos_id: int = 0
    dir_id: int = 0

    # HashGrid parameters (reference: src/AppConfig.cpp:19-27)
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0

    # TriangleWave / Frequency parameters (src/AppConfig.cpp:36-48,70-76)
    pos_n_frequencies: int = 12
    dir_n_frequencies: int = 4
    oneblob_n_bins: int = 4


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Scene preset. Mirrors AppConfig::HpmSceneConfig (src/AppConfig.cpp:93-150).

    The reference hard-codes ``hdrEnvMapPath=""`` for every preset and its HDR
    loader overwrites every texel with 1.0 ("Test overwrite",
    src/read_file.cpp:130), so the env map is always constant white and env
    radiance == ``hdr_env_map_strength``. We keep that behavior for the
    presets but support real equirect HDR maps through ``hdr_env_map_path``.
    """

    id: int = 4
    dir_light_strength: float = 8.0
    point_light_strength: float = 0.0
    hdr_env_map_path: str = ""
    hdr_env_map_strength: float = 0.1
    density: float = 0.6
    dynamic: bool = False

    # Volume source. The reference hardcodes wdas_cloud_quarter.vdb
    # (src/HpmScene.cpp:44) but only the sixteenth VDB is present in data/.
    volume_path: str = "data/volume/wdas_cloud_sixteenth.vdb"
    # Henyey-Greenstein anisotropy, hardcoded 0.8 in HpmScene.cpp:45.
    volume_g: float = 0.8

    @staticmethod
    def preset(scene_id: int) -> "SceneConfig":
        """The six presets of src/AppConfig.cpp:96-149."""
        table = {
            0: dict(dir_light_strength=16.0, point_light_strength=0.0,
                    hdr_env_map_strength=0.0, density=0.6),
            1: dict(dir_light_strength=0.0, point_light_strength=64.0,
                    hdr_env_map_strength=0.0, density=0.6),
            2: dict(dir_light_strength=0.0, point_light_strength=128.0,
                    hdr_env_map_strength=0.0, density=1.0),
            3: dict(dir_light_strength=16.0, point_light_strength=0.0,
                    hdr_env_map_strength=0.0, density=0.25),
            4: dict(dir_light_strength=8.0, point_light_strength=0.0,
                    hdr_env_map_strength=0.1, density=0.6),
            5: dict(dir_light_strength=0.0, point_light_strength=0.0,
                    hdr_env_map_strength=1.0, density=1.6),
        }
        if scene_id not in table:
            raise ValueError(f"HpmSceneConfig ID is invalid: {scene_id}")
        return SceneConfig(id=scene_id, **table[scene_id])


@dataclasses.dataclass(frozen=True)
class RestirConfig:
    """ReSTIR path-reservoir parameters — the spec constants of
    data/shader/include/restir-constants.glsl:1-11.  The reference's
    RestirHpmRenderer is entirely commented out (src/RestirHpmRenderer.cpp
    is one block comment, SURVEY §2.5); this build makes the shader
    pipeline operational."""

    path_vertex_count: int = 8
    spatial_kernel_size: int = 3
    temporal_kernel_size: int = 2
    # Beyond-reference (round 5): weighted-RIS splicing with the phase
    # reconnection factor as the resampling target and the RIS
    # contribution weight applied at shading.  False reproduces the
    # shader's uniform 1/stream splicing exactly (models/restir.py).
    mis_weights: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding configuration (new capability; the reference is
    single-GPU with no distributed anything — SURVEY.md §5)."""

    # Number of devices along the 'rays' (pixel/data-parallel) axis.
    # None => use all local devices.
    rays: Optional[int] = None
    axis_name: str = "rays"


@dataclasses.dataclass(frozen=True)
class AppConfig:
    """Full experiment config — 17 parameters matching the positional CLI of
    the reference (src/AppConfig.cpp:154-182) plus fields of this build."""

    # NN training (args 1-4)
    loss_fn: str = "RelativeL2Luminance"
    optimizer: str = "Adam"
    learning_rate: float = 0.01
    ema_decay: float = 0.99

    # Encoding (args 5-6)
    encoding: EncodingConfig = dataclasses.field(default_factory=EncodingConfig)

    # Network (args 7-11)
    nn_width: int = 64
    nn_depth: int = 6
    log2_infer_batch_size: int = 21
    log2_train_batch_size: int = 14
    train_batch_count: int = 4

    # Scene (arg 12)
    scene: SceneConfig = dataclasses.field(
        default_factory=lambda: SceneConfig.preset(4))

    # Path tracing (args 13-17)
    train_ring_buf_size: float = 1.0
    train_spp: int = 1
    primary_ray_length: int = 1
    primary_ray_prob: float = 0.0
    train_ray_length: int = 32

    # Render target (main.cu:156-157)
    render_width: int = 1920
    render_height: int = 1080

    # ReSTIR renderer constants (restir-constants.glsl)
    restir: RestirConfig = dataclasses.field(default_factory=RestirConfig)

    # Knobs of this build --------------------------------------------------
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Cap on stochastic-tracking iterations (reference caps at 128,
    # data/shader/include/path_trace.glsl:34,161).
    max_track_steps: int = 128
    # Hard cap on primary-path bounces (nrc/gen_rays.comp:41 caps at 128).
    max_primary_bounces: int = 128
    # MC ground-truth path length (main.cu:212 uses 32; golden-image
    # generation uses 64, Reference.cpp:581).
    mc_path_length: int = 32
    # Compute dtype for the MLP matmuls; path-trace math stays float32.
    mlp_dtype: str = "bfloat16"
    # Ray-batch chunking: the per-pixel trace runs as lax.map over this many
    # chunks so chunks whose rays all miss (or resolve early) skip their
    # tracking segments entirely. 1 disables. Must divide the pixel count.
    # Default 1 since round 2: lane/event compaction (ops/compaction.py,
    # transmittance.py stages) removes dead-lane cost WITHIN one batch, and
    # chunking only adds loop latency once compaction is on.
    trace_chunks: int = 1
    # Skip NRC inference for batches with no scattered samples — the
    # reference's NrcInferFilter (prep_infer_rays.comp:44-45,
    # NeuralRadianceCache.cu:134-145) rebuilt as a lax.cond per batch.
    infer_filter: bool = True
    # Compaction: trace only box-hitting rays via a gather + dense lax.cond
    # fallback BEFORE the primary pass.  Default OFF since round 3: the
    # event-stage compaction inside the tracking loops resolves miss lanes
    # (zero residual depth) before their first fine gather, so the outer
    # gather is nearly redundant at runtime — but its dense fallback
    # re-traces the whole primary stack a second time, roughly doubling
    # compile time.
    compact: bool = False
    infer_compact: bool = True
    # Static capacity of the scattered-pixel inference compaction as a
    # fraction of the screen (the scatter fraction of the WDAS cloud's
    # reference view is 0.22).
    infer_compact_frac: float = 0.30
    # Hash-grid training path: bf16 packed-gather forward + one-hot
    # matmul-scatter backward (encoding.hash_grid_encode_train).  Only
    # takes effect for level tables <= 2^16 (log2_hashmap_size <= 16).
    hash_train_fast: bool = True
    # Golden-era env transmittance (see integrator.TraceParams.env_fixed16):
    # the upstream checked-in goldens were generated with the now-commented
    # GetTransmittance(pos, exit, 16) env estimator (path_trace.glsl:100)
    # rather than the current RatioTrack line; True replicates that for
    # golden-comparable renders of the env-lit presets (4/5).
    env_fixed16: bool = False
    # Train-target radiance clamp (prep_train_rays.comp:58 hardcodes 8.0).
    # Exposed as a knob for bias experiments: the clamp truncates bright
    # target mass, one suspected driver of the scene-0 NRC relBias
    # (BASELINE.md round 5).  8.0 = reference parity.
    train_target_clamp: float = 8.0
    # Cache-bootstrapped train targets (beyond-reference, the NRC paper's
    # own self-training trick): train paths that survive all
    # train_ray_length bounces terminate INTO the EMA cache — the
    # prediction at the terminal (pos, dir), scaled by the path
    # throughput, is added to the target before the 8.0 clamp.  The
    # reference truncates instead (prep_train_rays.comp:68-99), which is
    # the measured ~-0.11 steady-state relBias on scene 4 (BASELINE.md).
    # Default OFF for reference parity.
    train_cache_bootstrap: bool = False

    # ------------------------------------------------------------------
    @property
    def infer_batch_size(self) -> int:
        # 2 << (log2-1) == 2**log2  (NeuralRadianceCache.cu:12)
        return 2 << (self.log2_infer_batch_size - 1)

    @property
    def train_batch_size(self) -> int:
        return 2 << (self.log2_train_batch_size - 1)

    @property
    def train_pixel_count(self) -> int:
        return self.train_batch_count * self.train_batch_size

    def train_subset(self) -> tuple[int, int, int, int]:
        """(train_w, train_h, x_dist, y_dist).

        Mirrors NrcHpmRenderer::CalcTrainSubset (NrcHpmRenderer.cu:612-642):
        factor train_pixel_count into the most-square (w, h) pair with the
        bigger factor along the wider screen dimension; strides are integer
        screen/train ratios.

        Divergence (documented fix of reference quirk): the reference's
        spec-constant table maps TRAIN_Y_DIST to the trainXDist offset
        (NrcHpmRenderer.cu:968), so its shaders stride Y by the X distance
        and read out of bounds on non-square factorizations. We use the
        correct per-axis strides.
        """
        n = self.train_pixel_count
        f = int(n ** 0.5)
        while f >= 2:
            if n % f == 0:
                other = n // f
                big, small = max(f, other), min(f, other)
                if self.render_width > self.render_height:
                    tw, th = big, small
                else:
                    tw, th = small, big
                return tw, th, self.render_width // tw, self.render_height // th
            f -= 1
        raise ValueError(
            f"Could not find suitable division of trainPixelCount {n}")

    @property
    def train_ring_size(self) -> int:
        """Ring buffer capacity = train_ring_buf_size * train pixel count."""
        return int(self.train_ring_buf_size * self.train_pixel_count)

    def name(self) -> str:
        """Underscore-joined config string used as the output directory name
        (mirrors AppConfig::GetName, src/AppConfig.cpp:184-205)."""
        parts = [
            self.loss_fn, self.optimizer,
            f"{self.learning_rate:.6f}", f"{self.ema_decay:.6f}",
            str(self.encoding.pos_id), str(self.encoding.dir_id),
            str(self.nn_width), str(self.nn_depth),
            str(self.log2_infer_batch_size), str(self.log2_train_batch_size),
            str(self.train_batch_count), str(self.scene.id),
            f"{self.train_ring_buf_size:.6f}", str(self.train_spp),
            str(self.primary_ray_length), f"{self.primary_ray_prob:.6f}",
            str(self.train_ray_length),
        ]
        return "_".join(parts)

    @staticmethod
    def from_argv(argv: Sequence[str]) -> "AppConfig":
        """Parse the reference's 17 positional args (src/AppConfig.cpp:154-182).

        ``argv`` excludes the program name; length must be 17.
        """
        if len(argv) != 17:
            raise ValueError(
                "Argument count does not match requirements for AppConfig "
                f"(got {len(argv)}, want 17)")
        it = iter(argv)
        loss_fn = next(it)
        optimizer = next(it)
        lr = float(next(it))
        ema = float(next(it))
        pos_id = int(next(it))
        dir_id = int(next(it))
        width = int(next(it))
        depth = int(next(it))
        log2_infer = int(next(it))
        log2_train = int(next(it))
        tbc = int(next(it))
        scene_id = int(next(it))
        ring = float(next(it))
        spp = int(next(it))
        prl = int(next(it))
        prp = float(next(it))
        trl = int(next(it))
        return AppConfig(
            loss_fn=loss_fn, optimizer=optimizer, learning_rate=lr,
            ema_decay=ema,
            encoding=EncodingConfig(pos_id=pos_id, dir_id=dir_id),
            nn_width=width, nn_depth=depth,
            log2_infer_batch_size=log2_infer, log2_train_batch_size=log2_train,
            train_batch_count=tbc, scene=SceneConfig.preset(scene_id),
            train_ring_buf_size=ring, train_spp=spp,
            primary_ray_length=prl, primary_ray_prob=prp, train_ray_length=trl)


# The defaults injected when the reference binary runs with no arguments
# (src/main.cu:429-439).
DEFAULT_ARGV = [
    "RelativeL2Luminance", "Adam", "0.01", "0.99",
    "0", "0",
    "64", "6", "21", "14", "4",
    "4",
    "1.0", "1", "1", "0.0", "32",
]
