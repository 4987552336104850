from .gather_interp import Section, eval_sections, separable_section

__all__ = ["Section", "eval_sections", "separable_section"]
