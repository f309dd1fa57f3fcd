from setuptools import setup, find_packages

exec(open('imagen_tpu/version.py').read())

setup(
    name='imagen-tpu',
    packages=find_packages(exclude=['tests*']),
    include_package_data=True,
    package_data={'imagen_tpu': ['default_config.json'],
                  'imagen_tpu_torch': ['csrc/*.cu', 'native/imagen_io.cpp',
                                       'default_config.json']},
    entry_points={
        'console_scripts': [
            'imagen_tpu = imagen_tpu.cli:main',
            'imagen = imagen_tpu.cli:imagen',
            'imagen_torch = imagen_tpu_torch.cli:imagen',
        ],
    },
    version=__version__,
    license='MIT',
    description='Imagen - TPU-native text-to-image cascaded diffusion (JAX/XLA/Pallas)',
    long_description_content_type='text/markdown',
    keywords=[
        'artificial intelligence',
        'deep learning',
        'text-to-image',
        'diffusion',
        'tpu',
        'jax',
    ],
    install_requires=[
        'jax',
        'flax',
        'optax',
        'einops>=0.7',
        'numpy',
        'pydantic>=2',
        'click',
        'fsspec',
        'packaging',
        'sentencepiece',
        'transformers',
        'tqdm',
        'pillow',
    ],
    classifiers=[
        'Development Status :: 4 - Beta',
        'Intended Audience :: Developers',
        'Topic :: Scientific/Engineering :: Artificial Intelligence',
        'License :: OSI Approved :: MIT License',
        'Programming Language :: Python :: 3.10',
    ],
)
