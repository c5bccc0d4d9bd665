from eioku_tpu_torch.web.framework import (
    App,
    FileResponse,
    HTTPException,
    JSONResponse,
    PlainTextResponse,
    Request,
    Response,
)

__all__ = [
    "App",
    "Request",
    "Response",
    "JSONResponse",
    "PlainTextResponse",
    "FileResponse",
    "HTTPException",
]
