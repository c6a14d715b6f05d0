from .server import VideoGenServer

__all__ = ["VideoGenServer"]
