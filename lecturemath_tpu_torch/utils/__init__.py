from .synthetic import synthetic_lecture, SyntheticGlyph
