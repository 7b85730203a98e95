"""Default config tree — the TPU framework's analogue of the reference's
configs/_base_/common_base.py + gdrn_base.py (cited per-section below). Every
key the reference's experiment configs override exists here with the same
name and default, so those configs port 1:1; TPU-specific keys live under
SOLVER (bf16), ENGINE and PARALLEL.
"""

from __future__ import annotations

import copy

from gdrnet_tpu_torch.config.config import Config

_DEFAULTS = dict(
    OUTPUT_ROOT="output",
    OUTPUT_DIR="auto",
    EXP_NAME="",
    DEBUG=False,
    SEED=-1,
    VIS_PERIOD=0,
    # INPUT: reference common_base.py INPUT dict
    INPUT=dict(
        FORMAT="BGR",
        MIN_SIZE_TRAIN=(480,),
        MAX_SIZE_TRAIN=640,
        MIN_SIZE_TRAIN_SAMPLING="choice",
        MIN_SIZE_TEST=480,
        MAX_SIZE_TEST=640,
        WITH_DEPTH=False,
        AUG_DEPTH=False,
        COLOR_AUG_PROB=0.0,
        COLOR_AUG_TYPE="ROI10D",
        COLOR_AUG_CODE="",
        COLOR_AUG_SYN_ONLY=False,
        BG_TYPE="VOC_table",
        BG_IMGS_ROOT="datasets/VOCdevkit/VOC2012/",
        NUM_BG_IMGS=10000,
        CHANGE_BG_PROB=0.5,
        TRUNCATE_FG=False,
        BG_KEEP_ASPECT_RATIO=True,
        DZI_TYPE="uniform",
        DZI_PAD_SCALE=1.0,
        DZI_SCALE_RATIO=0.25,
        DZI_SHIFT_RATIO=0.25,
        SMOOTH_XYZ=False,
        # TPU-first: host only decodes/augments bytes; DZI, crops, and every
        # target tensor are computed on device as one XLA program
        # (data/device_pipeline.device_train_batch)
        DEVICE_PREPROCESS=False,
        # move COLOR_AUG into that XLA program too (aae/code/roi10d types;
        # data/device_augment.py) — host then stops after decode + bg
        DEVICE_COLOR_AUG=False,
    ),
    DATASETS=dict(
        TRAIN=(),
        TRAIN2=(),
        TRAIN2_RATIO=0.0,
        TEST=(),
        DET_FILES_TEST=(),
        DET_TOPK_PER_OBJ=1,
        DET_THR=0.0,
        SYM_OBJS=["bowl", "cup", "eggbox", "glue"],
    ),
    DATALOADER=dict(
        NUM_WORKERS=4,
        SAMPLER_TRAIN="TrainingSampler",
        REPEAT_THRESHOLD=0.0,
        FILTER_EMPTY_ANNOTATIONS=True,
        FILTER_EMPTY_DETS=True,
        FILTER_VISIB_THR=0.0,
    ),
    # SOLVER: reference common_base.py SOLVER dict; precision defaults flipped
    # to TPU-native bf16 (the reference's AMP fp16 analogue).
    SOLVER=dict(
        IMS_PER_BATCH=6,
        TOTAL_EPOCHS=160,
        OPTIMIZER_CFG=dict(type="Ranger", lr=1e-4, weight_decay=0),
        GAMMA=0.1,
        BIAS_LR_FACTOR=1.0,
        LR_SCHEDULER_NAME="flat_and_anneal",
        WARMUP_METHOD="linear",
        WARMUP_FACTOR=1.0 / 1000,
        WARMUP_ITERS=1000,
        ANNEAL_METHOD="cosine",
        ANNEAL_POINT=0.72,
        TARGET_LR_FACTOR=0.0,  # reference spells it TARTGET_LR_FACTOR (sic)
        POLY_POWER=0.9,
        REL_STEPS=(0.5, 0.75),
        CHECKPOINT_PERIOD=5,
        CHECKPOINT_BY_EPOCH=True,
        MAX_TO_KEEP=5,
        AMP=dict(ENABLED=False),  # reference key; on TPU means bf16 compute
        GRAD_CLIP=0.0,
        # skip the optimizer update (params/opt/BN unchanged) when the loss
        # or any grad is non-finite — the reference's AMP GradScaler skips
        # inf/nan steps the same way (torch.cuda.amp in main_gdrn.py:141);
        # metrics gain "nonfinite_skip" and the trainer raises only when
        # SKIP_NONFINITE_PATIENCE consecutive print boundaries are skipped.
        SKIP_NONFINITE=True,
        SKIP_NONFINITE_PATIENCE=5,
        # >1: average grads over k micro-batches per optimizer step
        GRAD_ACCUM_STEPS=1,
    ),
    TRAIN=dict(PRINT_FREQ=100, VERBOSE=False, VIS=False, VIS_IMG=False,
               # jax.profiler trace of [PROFILE_START, PROFILE_STOP) train
               # iters into <PROFILE_DIR>; "" disables (SURVEY.md §5 tracing
               # plan — the reference has no profiler integration)
               PROFILE_DIR="", PROFILE_START=10, PROFILE_STOP=15,
               # HBM-resident training pool (data/device_pool.py): map every
               # record once, keep the compact pool on device, gather batches
               # by sampler indices each step; POOL_REFRESH re-augments slots
               # in the background (fresh DZI/color aug) at link bandwidth
               DEVICE_RESIDENT_POOL=False, POOL_REFRESH=True,
               POOL_REFRESH_CHUNK=64),
    VAL=dict(
        DATASET_NAME="lm",
        RESULTS_PATH="",
        TARGETS_FILENAME="",
        ERROR_TYPES="ad,rete,re,te,proj",
        RENDERER_TYPE="batch_xla",
        SPLIT="test",
        SPLIT_TYPE="",
        N_TOP=1,
        EVAL_CACHED=False,
        SCORE_ONLY=False,
        EVAL_PRINT_ONLY=False,
        EVAL_PRECISION=False,
        USE_BOP=False,
    ),
    TEST=dict(
        EVAL_PERIOD=0,
        VIS=False,
        TEST_BBOX_TYPE="gt",
        USE_PNP=False,
        PNP_TYPE="ransac_pnp",
        # solve the PnP refinement for the whole ROI bucket as one jitted
        # XLA program (ops/device_pnp.py: weighted EPnP + Gumbel-top-k
        # RANSAC + LM polish) instead of per-ROI cv2 on host CPU — the
        # reference's eval-time hot spot (gdrn_evaluator.py:187-435)
        DEVICE_PNP=False,
        PRECISE_BN=dict(ENABLED=False, NUM_ITER=200),
        AMP_TEST=False,
        # int8 MXU serving path (post-training quantization of backbone +
        # geometry-head convs, models/quantize.py); calibrated on the first
        # test bucket. No reference analogue (AMP fp16 is the closest).
        INT8=False,
        FOLD_BN=False,  # fold BN stats into conv kernels for serving
        ROI_BATCH_SIZE=64,  # padded ROI bucket size at test (TPU static shapes)
        # crop ROIs on device from raw deduped frames (serving path)
        DEVICE_PREPROCESS=False,
        # CE-mode xyz decode: "center" ((idx+0.5)/bin, for self-trained
        # models) | "reference" (idx/(bin-1), bit-faithful to converted
        # reference checkpoints — engine_utils.py:103)
        CE_DECODE_TYPE="center",
        # local data-parallel inference: shard each ROI bucket over this many
        # local devices via GSPMD (-1 = all, clamped to a divisor of
        # ROI_BATCH_SIZE). One process drives every chip on the host; the
        # reference needs a DDP process per GPU for the same coverage.
        LOCAL_DEVICES=-1,
    ),
    # MODEL: reference gdrn_base.py MODEL dict
    MODEL=dict(
        DEVICE="tpu",
        WEIGHTS="",
        PIXEL_MEAN=[0.0, 0.0, 0.0],
        PIXEL_STD=[255.0, 255.0, 255.0],
        LOAD_DETS_TEST=False,
        CDPN=dict(
            NAME="GDRN",
            TASK="rot",
            USE_MTL=False,
            BACKBONE=dict(
                PRETRAINED="",
                ARCH="resnet",
                NUM_LAYERS=34,
                INPUT_CHANNEL=3,
                INPUT_RES=256,
                OUTPUT_RES=64,
                FREEZE=False,
            ),
            ROT_HEAD=dict(
                FREEZE=False,
                ROT_CONCAT=False,
                XYZ_BIN=64,
                NUM_LAYERS=3,
                NUM_FILTERS=256,
                CONV_KERNEL_SIZE=3,
                NORM="BN",
                NUM_GN_GROUPS=32,
                OUT_CONV_KERNEL_SIZE=1,
                NUM_CLASSES=13,
                ROT_CLASS_AWARE=False,
                XYZ_LOSS_TYPE="L1",
                XYZ_LOSS_MASK_GT="visib",
                XYZ_LW=1.0,
                MASK_CLASS_AWARE=False,
                MASK_LOSS_TYPE="L1",
                MASK_LOSS_GT="trunc",
                MASK_LW=1.0,
                MASK_THR_TEST=0.5,
                NUM_REGIONS=8,
                REGION_CLASS_AWARE=False,
                REGION_LOSS_TYPE="CE",
                REGION_LOSS_MASK_GT="visib",
                REGION_LW=1.0,
            ),
            PNP_NET=dict(
                FREEZE=False,
                R_ONLY=False,
                LR_MULT=1.0,
                PNP_HEAD_CFG=dict(type="ConvPnPNet", norm="GN", num_gn_groups=32, drop_prob=0.0),
                WITH_2D_COORD=False,
                REGION_ATTENTION=False,
                MASK_ATTENTION="none",
                TRANS_WITH_BOX_INFO="none",
                ROT_TYPE="ego_rot6d",
                TRANS_TYPE="centroid_z",
                Z_TYPE="REL",
                NUM_PM_POINTS=3000,
                PM_LOSS_TYPE="L1",
                PM_SMOOTH_L1_BETA=1.0,
                PM_LOSS_SYM=False,
                PM_NORM_BY_EXTENT=False,
                PM_R_ONLY=True,
                PM_DISENTANGLE_T=False,
                PM_DISENTANGLE_Z=False,
                PM_T_USE_POINTS=False,
                PM_LW=1.0,
                ROT_LOSS_TYPE="angular",
                ROT_LW=0.0,
                CENTROID_LOSS_TYPE="L1",
                CENTROID_LW=0.0,
                Z_LOSS_TYPE="L1",
                Z_LW=0.0,
                TRANS_LOSS_TYPE="L1",
                TRANS_LOSS_DISENTANGLE=True,
                TRANS_LW=0.0,
                BIND_LOSS_TYPE="L1",
                BIND_LW=0.0,
            ),
            TRANS_HEAD=dict(
                ENABLED=False,
                FREEZE=True,
                LR_MULT=1.0,
                NUM_LAYERS=3,
                NUM_FILTERS=256,
                NORM="BN",
                NUM_GN_GROUPS=32,
                CONV_KERNEL_SIZE=3,
                OUT_CHANNEL=3,
                TRANS_TYPE="centroid_z",
                Z_TYPE="REL",
                CENTROID_LOSS_TYPE="L1",
                CENTROID_LW=0.0,
                Z_LOSS_TYPE="L1",
                Z_LW=0.0,
                TRANS_LOSS_TYPE="L1",
                TRANS_LW=0.0,
            ),
        ),
    ),
    # TPU-specific: device mesh / sharding layout
    PARALLEL=dict(
        MESH_SHAPE=(-1,),  # 1-D data mesh over all devices
        AXIS_NAMES=("data",),
        # tensor-shard large kernels' output dim over a second mesh axis
        # (parallel/mesh.py param_partition_spec; DP stays on axis 0).
        # 1 = pure DP like the reference; >1 needs device count divisible
        MODEL_PARALLEL=1,
        DTYPE="bfloat16",  # compute dtype inside the model (params stay f32)
        REMAT=False,  # rematerialize backbone blocks (bigger batches, +FLOPs)
    ),
)


def base_config() -> Config:
    return Config(copy.deepcopy(_DEFAULTS))
