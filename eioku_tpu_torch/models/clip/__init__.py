from eioku_tpu_torch.models.clip.model import (  # noqa: F401
    CLIP,
    ClipConfig,
    clip_encode_image,
    clip_encode_text,
    convert_hf_state_dict,
    from_jax_params,
    init_clip,
    load_clip,
    preprocess_images,
)
