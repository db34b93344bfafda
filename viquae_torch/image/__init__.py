"""Image and face stages: global image embeddings, MTCNN detection,
ArcFace alignment + embedding, box scaling and corpus thumbnailing."""
