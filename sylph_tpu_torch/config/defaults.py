"""Default config tree (the port's own copy of sylph_tpu/config/defaults.py).

Preserves the reference's key vocabulary so its YAML configs port over:
  * base detectron2/d2go keys the reference relies on (MODEL.BACKBONE,
    MODEL.FPN, SOLVER, DATASETS, INPUT, TEST);
  * AdelaiDet FCOS keys (reference: sylph/runner/adet_configs.py:25-61);
  * Sylph keys (reference: sylph/runner/default_configs.py:9-198).

TPU-specific additions live under ``TPU.*`` (mesh/canvas/padding knobs that
the reference never needed because torch allowed dynamic shapes).
"""

from .config import CfgNode


def get_default_cfg() -> CfgNode:
    _C = CfgNode()

    _C.VERSION = 2
    _C.SEED = -1  # reference: default_configs.py:40
    _C.OUTPUT_DIR = "./output"

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CfgNode()
    _C.MODEL.DEVICE = "tpu"
    _C.MODEL.META_ARCHITECTURE = "MetaOneStageDetector"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.WEIGHTS_FILTER_BY_MODULE = []  # reference: default_configs.py:18
    _C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]  # BGR, detectron2 default
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
    _C.MODEL.MASK_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    # DDP fp16 gradient compression (reference train_net.py:71-78). Key
    # kept for config compat.
    _C.MODEL.DDP_FP16_GRAD_COMPRESS = False
    _C.MODEL.DDP_FIND_UNUSED_PARAMETERS = False

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_fcos_resnet_fpn_backbone"
    _C.MODEL.BACKBONE.FREEZE = False          # reference: default_configs.py:24
    _C.MODEL.BACKBONE.FREEZE_EXCLUDE = []     # reference: default_configs.py:25
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.RESNETS = CfgNode()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True  # caffe2-style R-50 (MSRA weights)

    _C.MODEL.FPN = CfgNode()
    _C.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"
    _C.MODEL.FPN.TOP_LEVELS = 2  # P6,P7 from P5 (reference: adet_configs.py:39)

    _C.MODEL.PROPOSAL_GENERATOR = CfgNode()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "MetaFCOS"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0
    # Freeze / OWD switches (reference: default_configs.py:27-35)
    _C.MODEL.PROPOSAL_GENERATOR.OWD = False
    _C.MODEL.PROPOSAL_GENERATOR.FREEZE_CLS_TOWER = False
    _C.MODEL.PROPOSAL_GENERATOR.FREEZE_CLS_LOGITS = False
    _C.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_BRANCH = False
    _C.MODEL.PROPOSAL_GENERATOR.FREEZE_BBOX_TOWER = False
    _C.MODEL.PROPOSAL_GENERATOR.FREEZE = False

    # ------------------------------------------------------------ MODEL.FCOS
    # Reference: adet_configs.py:25-61 plus default_configs.py:44-50.
    _C.MODEL.FCOS = CfgNode()
    _C.MODEL.FCOS.NUM_CLASSES = 80
    _C.MODEL.FCOS.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    _C.MODEL.FCOS.FPN_STRIDES = [8, 16, 32, 64, 128]
    _C.MODEL.FCOS.PRIOR_PROB = 0.01
    _C.MODEL.FCOS.INFERENCE_TH_TRAIN = 0.05
    _C.MODEL.FCOS.INFERENCE_TH_TEST = 0.05
    _C.MODEL.FCOS.NMS_TH = 0.6
    _C.MODEL.FCOS.PRE_NMS_TOPK_TRAIN = 1000
    _C.MODEL.FCOS.PRE_NMS_TOPK_TEST = 1000
    _C.MODEL.FCOS.POST_NMS_TOPK_TRAIN = 100
    _C.MODEL.FCOS.POST_NMS_TOPK_TEST = 100
    _C.MODEL.FCOS.TOP_LEVELS = 2
    _C.MODEL.FCOS.NORM = "GN"
    _C.MODEL.FCOS.USE_SCALE = True
    _C.MODEL.FCOS.THRESH_WITH_CTR = False
    _C.MODEL.FCOS.LOSS_ALPHA = 0.25
    _C.MODEL.FCOS.LOSS_GAMMA = 2.0
    _C.MODEL.FCOS.SIZES_OF_INTEREST = [64, 128, 256, 512]
    _C.MODEL.FCOS.USE_RELU = True
    _C.MODEL.FCOS.USE_DEFORMABLE = False
    _C.MODEL.FCOS.NUM_CLS_CONVS = 4
    _C.MODEL.FCOS.NUM_BOX_CONVS = 4
    _C.MODEL.FCOS.NUM_SHARE_CONVS = 0
    _C.MODEL.FCOS.CENTER_SAMPLE = True
    _C.MODEL.FCOS.POS_RADIUS = 1.5
    _C.MODEL.FCOS.LOC_LOSS_TYPE = "giou"
    _C.MODEL.FCOS.YIELD_PROPOSAL = False
    # Sylph FCOS extras (reference: default_configs.py:44-50)
    _C.MODEL.FCOS.BOX_QUALITY = ["ctrness"]
    _C.MODEL.FCOS.IOU_MASK = False
    _C.MODEL.FCOS.CLS_LOGITS_KERNEL_SIZE = 1
    _C.MODEL.FCOS.L2_NORM_CLS_WEIGHT = False

    # ------------------------------------------------------------- MODEL.TFA
    # Reference: default_configs.py:53-62.
    _C.MODEL.TFA = CfgNode()
    _C.MODEL.TFA.FINETINE = False
    _C.MODEL.TFA.TRAIN_SHOT = 10
    _C.MODEL.TFA.USE_PRETRAINED_BASE_CLS_LOGITS = True
    _C.MODEL.TFA.EVAL_WITH_PRETRAINED_BASE_CLS_LOGITS = False

    # ------------------------------------------------------ MODEL.META_LEARN
    # Reference: default_configs.py:65-140.
    ML = CfgNode()
    _C.MODEL.META_LEARN = ML
    ML.EPISODIC_LEARNING = False
    ML.SHOT = 5
    ML.EVAL_SHOT = 10
    ML.BASE_EVAL_SHOT = 10
    ML.CLASS = 5
    ML.USE_ALL_GTS_IN_BASE_CLASSES = True
    ML.EVAL_WITH_PRETRAINED_CODE = False
    ML.QUERY_SHOT = 1

    CG = CfgNode()
    ML.CODE_GENERATOR = CG
    CG.NAME = "CodeGenerator"
    CG.FREEZE = False
    CG.DISTILLATION_LOSS_WEIGHT = 0.0
    CG.ROI_BOX = CfgNode()
    CG.ROI_BOX.POOLER_RESOLUTION = 7
    CG.ROI_BOX.POOLER_TYPE = "ROIAlignV2"
    CG.ROI_BOX.FPN_MULTILEVEL_FEATURE = False
    # CodeGenerator specifics (reference: default_configs.py:99-140)
    CG.USE_MASK = True
    CG.ALL_MASK = False
    CG.MASK_NORM = "GN"
    CG.CONV_L2_NORM = False
    CG.USE_BIAS = True
    CG.BIAS_L2_NORM = False
    CG.TOWER_LAYERS = [["GN", ""]]
    CG.CLS_LAYER = ["GN", "", 1]
    CG.USE_WEIGHT_SCALE = True
    CG.BIAS_LAYER = []
    CG.WEIGHT_LAYER = []
    CG.SCALE_LAYER = []
    CG.BOX_ON = False
    CG.BOX_TOWER_LAYERS = []
    CG.BOX_CLS_LAYER = ["", "", 2]
    CG.BOX_BIAS_LAYER = []
    CG.CONTRASTIVE_LOSS = ""
    CG.INIT_NORM_LAYER = False
    CG.CLS_REWEIGHT = False
    CG.META_WEIGHT = False
    CG.META_BIAS = False
    CG.USE_PER_CLS_SCALE = False
    CG.COMPRESS_CODE_W_MAX = False
    CG.POST_NORM = "GN"
    CG.IN_CHANNEL = 256
    CG.OUT_CHANNEL = 256
    CG.USE_DEFORMABLE = False
    # ROIEncoder variant (reference: default_configs.py:143-160)
    CG.TOKENIZER = CfgNode()
    CG.TOKENIZER.NUM_CONV = 0
    CG.TOKENIZER.CONV_DIM = 256
    CG.TOKENIZER.NORM = ""
    CG.TOKENIZER.NUM_FC = 1
    CG.TOKENIZER.FC_DIM = 256
    CG.TRANSFORMER_ENCODER = CfgNode()
    CG.TRANSFORMER_ENCODER.LAYERS = 1
    CG.TRANSFORMER_ENCODER.HEADS = 8
    CG.TRANSFORMER_ENCODER.DROPOUT = 0.1
    CG.HEAD = CfgNode()
    CG.HEAD.NUM_FC = 1
    CG.HEAD.FC_DIM = 512
    CG.HEAD.OUTPUT_DIM = 256

    # ------------------------------------------------------------- MODEL_EMA
    # d2go model EMA (reference: model_ema.EMAHook, meta_fcos_runner.py:350;
    # eval-with-EMA :692-699)
    _C.MODEL_EMA = CfgNode()
    _C.MODEL_EMA.ENABLED = False
    _C.MODEL_EMA.DECAY = 0.9998
    _C.MODEL_EMA.USE_EMA_WEIGHTS_FOR_EVAL_ONLY = False

    # ---------------------------------------------------------------- SOLVER
    _C.SOLVER = CfgNode()
    _C.SOLVER.MAX_ITER = 90000
    _C.SOLVER.BASE_LR = 0.01
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = [60000, 80000]
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.CLIP_GRADIENTS = CfgNode()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0

    # -------------------------------------------------------------- DATASETS
    _C.DATASETS = CfgNode()
    _C.DATASETS.TRAIN = []
    _C.DATASETS.TEST = []
    _C.DATASETS.ID_TRAIN = [0]            # reference: default_configs.py:11
    _C.DATASETS.ID_TEST = [0]
    _C.DATASETS.BASE_CLASSES_SPLIT = ""   # reference: default_configs.py:14
    _C.DATASETS.NOVEL_CLASSES_SPLIT = ""
    _C.DATASETS.NUMS_CLASSES = [0]

    _C.DATALOADER = CfgNode()
    _C.DATALOADER.NUM_WORKERS = 2
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.001
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True
    # fixed canvases make ratio grouping unnecessary; key kept for compat
    _C.DATALOADER.ASPECT_RATIO_GROUPING = False

    # ----------------------------------------------------------------- INPUT
    _C.INPUT = CfgNode()
    _C.INPUT.MIN_SIZE_TRAIN = [640, 672, 704, 736, 768, 800]
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.RANDOM_FLIP = "horizontal"
    # train-time augmentation toggles (the reference composes these via
    # d2go AugmentationList yaml; here they are explicit flags)
    _C.INPUT.USE_SCALE_JITTER = True
    _C.INPUT.RAND_AUGMENT = True

    # ------------------------------------------------------------------ TEST
    _C.TEST = CfgNode()
    _C.TEST.EVAL_PERIOD = 0           # reference: default_configs.py:21
    _C.TEST.REPEAT_TEST = 1           # reference: default_configs.py:95
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.SCORE_THRESH = 0.05

    # ------------------------------------------------------------------- TPU
    # Static-shape knobs with no reference analog. The key family keeps its
    # name so the repo's YAML configs load unchanged; the port reads the
    # canvases, the bank capacity, APPROX_TOPK, S2D_STEM, COMPUTE_DTYPE,
    # EVAL_BF16_RESIDENT and STEPS_PER_CALL.
    _C.TPU = CfgNode()
    _C.TPU.TRAIN_CANVAS = [1024, 1024]   # fixed train-time image canvas (H, W)
    _C.TPU.EVAL_CANVAS = [1024, 1344]    # fixed eval canvas (fits 800x1333 resize)
    # Support-set canvas: support images carry ONE object each; 384px is
    # ample for the 7x7 ROIAligned code features (the reference resizes
    # support to shortest-edge 800 — wasteful for a single crop).
    _C.TPU.SUPPORT_CANVAS = [384, 384]
    _C.TPU.MAX_GT_BOXES = 100            # per-image GT padding
    _C.TPU.DEVICE_RANDAUG = True
    _C.TPU.MAX_SUPPORT_BOXES = 1         # boxes pooled per support image
    _C.TPU.MAX_CLASSES = 1280            # class-code bank capacity (>=1203 LVIS)
    _C.TPU.NMS_CANDIDATES = 2048
    _C.TPU.EVAL_BATCH = 8                # query images per eval step
    _C.TPU.GRAD_ACCUM = 1                # micro-batches per train step
    _C.TPU.CLASS_BATCH = 8               # classes per registration dispatch
    _C.TPU.APPROX_TOPK = False           # the port always takes the exact top-k
    _C.TPU.S2D_STEM = False              # stem as 4x4/1 over space-to-depth
    _C.TPU.REMAT_BACKBONE = False
    _C.TPU.COMPUTE_DTYPE = "bfloat16"    # activation dtype; params stay float32
    _C.TPU.EVAL_BF16_RESIDENT = True     # eval weights in bf16 on the card
    _C.TPU.PRETRAIN_MICRO_BATCH = 8
    _C.TPU.MESH_DATA_AXIS = -1
    _C.TPU.STEPS_PER_CALL = 1            # optimizer steps per train-step call
    _C.TPU.TEST_MODE = False             # SYLPH_TEST_MODE analog (shrink everything)

    return _C
