from eioku_tpu_torch.models.vad.model import SileroVad, VadConfig, init_vad, vad_probs  # noqa: F401
