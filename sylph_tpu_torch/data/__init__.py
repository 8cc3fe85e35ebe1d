from .transforms import pad_to_canvas, resize_shortest_edge

__all__ = ["pad_to_canvas", "resize_shortest_edge"]
