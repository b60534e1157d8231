from repro_torch.roofline.analysis import RooflineTerms, analyze_compiled, collective_bytes_from_hlo

__all__ = ["RooflineTerms", "analyze_compiled", "collective_bytes_from_hlo"]
