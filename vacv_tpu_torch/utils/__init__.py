from .compare import MAX_DIFF, REF_MAX_DIFF, cosine_similarity, passes
