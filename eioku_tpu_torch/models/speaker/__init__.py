from eioku_tpu_torch.models.speaker.model import (  # noqa: F401
    ECAPA,
    EcapaConfig,
    ecapa_embed,
    fbank,
    init_ecapa,
    load_ecapa,
)
