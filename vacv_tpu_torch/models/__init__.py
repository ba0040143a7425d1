from .pipeline import PreprocessConfig, Preprocessor
