"""Models of the port, named as in ``horovod_tpu/models``: the Llama LM
(serving and training), the MoE LM and the model zoo — ResNet, VGG, Inception V3, the
MNIST MLP, BERT and ViT — with their weight converters in ``convert``."""

from .bert import (  # noqa: F401
    BERT_BASE,
    BERT_LARGE,
    BERT_TINY,
    BertConfig,
    BertEncoder,
    mlm_loss,
)
from .inception import InceptionV3  # noqa: F401
from .llama import (  # noqa: F401
    LLAMA_1B,
    LLAMA_300M,
    LLAMA_8B,
    LLAMA_TINY,
    DecodePath,
    LlamaConfig,
    LlamaLM,
    causal_lm_loss,
    chunked_causal_lm_loss,
    generate,
    init_kv_cache,
    token_nll,
)
from .mlp import MnistMLP  # noqa: F401
from .moe_lm import (  # noqa: F401
    MOE_SMALL,
    MOE_TINY,
    MoeBlock,
    MoeConfig,
    MoeFFN,
    MoeLM,
)
from .resnet import (  # noqa: F401
    ResNet,
    ResNet50,
    ResNet101,
    ResNet152,
    ResNetTiny,
)
from .vgg import (  # noqa: F401
    VGG,
    VGG11,
    VGG13,
    VGG16,
    VGG19,
    VGGTiny,
)
from .vit import (  # noqa: F401
    VIT_B16,
    VIT_S16,
    VIT_TINY,
    VisionTransformer,
    ViTConfig,
    classification_loss,
)
