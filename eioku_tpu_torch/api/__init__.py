from eioku_tpu_torch.api.app import AppContext, create_app

__all__ = ["create_app", "AppContext"]
